"""ms a frame in the online loop detection (loop_closure.detect: the
histogram prefilter, the eight candidates' scores, the gates and, where a
candidate passes them, the verification of the best five): the program's
span `online.loop_detect` (utils.profiling.recorded()), synchronised at
its end in traced runs."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    units = ctx["units"]
    if not hasattr(profiling, "recorded") or not units:
        return None
    s = profiling.recorded().total_s("online.loop_detect")
    return None if s is None else 1e3 * s / units
