"""ms a frame in publishing it: the one read of its pose and flags
(`fetch`) and its EKF step on the host (`online.ekf`), the program's
span `online.publish` (utils.profiling.recorded())."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    units = ctx["units"]
    if not hasattr(profiling, "recorded") or not units:
        return None
    s = profiling.recorded().total_s("online.publish")
    return None if s is None else 1e3 * s / units
