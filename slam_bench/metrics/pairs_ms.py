"""ms a chunk in the chunked front end's pair stage (the matches, the
dynamic filter, one gyro-fused RANSAC call over the consecutive and lag
pairs, the pins, the scale ratios and the track links): the program's
span `frontend.pairs` (utils.profiling.recorded()). The span reaches the
benchmark's synchronising Spans (the full cell's traced runs hand the
evaluator its timer), so its time is the host's launching and the
device's draining."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    units = len(ctx["spans"].get("chunk", ()))
    if not hasattr(profiling, "recorded") or not units:
        return None
    s = profiling.recorded().total_s("frontend.pairs")
    return None if s is None else 1e3 * s / units
