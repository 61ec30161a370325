"""ms a frame in the online step's detector at B = 1 (the resize, YOLO-s,
the gate, the top-k, NMS) and the box test of its keypoints: the
program's span `online.detect` (utils.profiling.recorded()), synchronised
at its end in traced runs."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    units = ctx["units"]
    if not hasattr(profiling, "recorded") or not units:
        return None
    s = profiling.recorded().total_s("online.detect")
    return None if s is None else 1e3 * s / units
