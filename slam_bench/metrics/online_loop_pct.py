"""Share (%) of the window's frames that applied a loop: the program's
counters `online.loops` over `online.frames`. Frames from 200 on revisit
a keyframe exactly; the online verify has no rotation-only rescue, so at
such a revisit its cheirality gate is decided by rounding."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    if not hasattr(profiling, "recorded"):
        return None
    counters = profiling.recorded().counters
    n = counters.get("online.frames", 0)
    return 100.0 * counters.get("online.loops", 0) / n if n else None
