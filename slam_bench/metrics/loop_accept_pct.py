"""Share (%) of the loop candidates verified that became loop edges: the
program's counters `loop.accepted` over `loop.verified` (the candidates
of every verify batch, its padding left out)."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    if not hasattr(profiling, "recorded"):
        return None
    counters = profiling.recorded().counters
    n = counters.get("loop.verified")
    return 100.0 * counters.get("loop.accepted", 0) / n if n else None
