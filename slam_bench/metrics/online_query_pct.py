"""Share (%) of the window's frames whose loop query found a candidate
past the gates, so that loop_closure.detect verified: the program's
counters `online.loop_queries` over `online.frames`."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    if not hasattr(profiling, "recorded"):
        return None
    counters = profiling.recorded().counters
    n = counters.get("online.frames", 0)
    return 100.0 * counters.get("online.loop_queries", 0) / n if n else None
