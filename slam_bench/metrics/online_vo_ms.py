"""ms a frame in the online step's visual odometry: the match against the
previous frame with the dynamic filter (`online.match`) and the pose
(`online.pose`: the gyro rotation, the gyro-fused RANSAC, the pins and
scale, the pose and its graph node), the program's spans
(utils.profiling.recorded()), each synchronised at its end in traced
runs."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    units = ctx["units"]
    if not hasattr(profiling, "recorded") or not units:
        return None
    parts = [profiling.recorded().total_s(n) for n in ("online.match", "online.pose")]
    if all(s is None for s in parts):
        return None
    return 1e3 * sum(s or 0.0 for s in parts) / units
