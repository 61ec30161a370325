"""ms a frame in the online step's extract (ORB and the undistortion of
one frame, B = 1): the program's span `online.extract`
(utils.profiling.recorded()). In traced runs the pipeline's stages take
the benchmark's synchronising Spans, so the time is the host's launching
and the device's draining."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    units = ctx["units"]
    if not hasattr(profiling, "recorded") or not units:
        return None
    s = profiling.recorded().total_s("online.extract")
    return None if s is None else 1e3 * s / units
