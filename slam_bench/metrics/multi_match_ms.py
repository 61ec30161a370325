"""ms a round in the batched front end's match over the S x C pairs and
their correspondence masks: the program's span `multi.match`
(utils.profiling.recorded()). No span of the batched front end
synchronises, so its time is the host's launch time; fetch_wait_ms holds
the wait for the device."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    units = ctx["units"]
    if not hasattr(profiling, "recorded") or not units:
        return None
    s = profiling.recorded().total_s("multi.match")
    return None if s is None else 1e3 * s / units
