"""ms a sequence in the pose graph's PCG solve of the damped normal
equations of every LM iteration, in finalize and in the loop
optimisations: the program's span `pose_graph.pcg`
(utils.profiling.recorded()). While recording, the span enters its
parent's timer (`loop_optimize`, `finalize.optimize`: the benchmark's
synchronising Spans in the full cell's traced runs), so its time is the
host's launching and the device's draining."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    units = ctx["units"]
    if not hasattr(profiling, "recorded") or not units:
        return None
    s = profiling.recorded().total_s("pose_graph.pcg")
    return None if s is None else 1e3 * s / units
