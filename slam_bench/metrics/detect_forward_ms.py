"""ms a chunk in the detector's forward pass over the chunk's C + 1 frames
(the resize and YOLO): the program's span `detect.forward`
(utils.profiling.recorded()). The span reaches the benchmark's
synchronising Spans (the full cell's traced runs hand the evaluator its
timer), so its time is the host's launching and the device's draining."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    units = len(ctx["spans"].get("chunk", ()))
    if not hasattr(profiling, "recorded") or not units:
        return None
    s = profiling.recorded().total_s("detect.forward")
    return None if s is None else 1e3 * s / units
