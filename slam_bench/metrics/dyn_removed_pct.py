"""Share (%) of the chunked front end's consecutive matches that the
dynamic-object filter removes: the program's counters
`frontend.dyn_removed` over `frontend.matches` (the ratio-passing
matches with valid endpoints, before the mask), read in the chunk's one
fetch. Reads 0 while the detector's weights are random."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    if not hasattr(profiling, "recorded"):
        return None
    counters = profiling.recorded().counters
    n = counters.get("frontend.matches")
    return 100.0 * counters.get("frontend.dyn_removed", 0) / n if n else None
