"""ms a sequence in the pose graph's linearisation (the edge residuals with
their reverse-mode Jacobians) of every LM iteration, in finalize and in
the loop optimisations: the program's span `pose_graph.linearize`
(utils.profiling.recorded()). While recording, the span enters its
parent's timer (`loop_optimize`, `finalize.optimize`: the benchmark's
synchronising Spans in the full cell's traced runs), so its time is the
host's launching and the device's draining."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    units = ctx["units"]
    if not hasattr(profiling, "recorded") or not units:
        return None
    s = profiling.recorded().total_s("pose_graph.linearize")
    return None if s is None else 1e3 * s / units
