"""ms a chunk in the chunked front end's extract (ORB over the chunk's C +
1 frames and their undistortion): the program's span `frontend.extract`
(utils.profiling.recorded()). The span reaches the benchmark's
synchronising Spans (the full cell's traced runs hand the evaluator its
timer), so its time is the host's launching and the device's draining."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    units = len(ctx["spans"].get("chunk", ()))
    if not hasattr(profiling, "recorded") or not units:
        return None
    s = profiling.recorded().total_s("frontend.extract")
    return None if s is None else 1e3 * s / units
