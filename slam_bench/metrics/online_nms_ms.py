"""ms a frame in the B = 1 detector's post-processing (the confidence
gate, the top-300 and the 300 rounds of greedy NMS, ops/boxes.nms): the
program's span `detect.post` (utils.profiling.recorded()). It enters the
synchronising timer of its stage, `online.detect`, in traced runs."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    units = ctx["units"]
    if not hasattr(profiling, "recorded") or not units:
        return None
    s = profiling.recorded().total_s("detect.post")
    return None if s is None else 1e3 * s / units
