"""Share (%) of the pose graph's LM iterations that replayed captured
CUDA graphs: the program's counters `pose_graph.graphed_iters` over
those plus `pose_graph.eager_iters` (iterations run op by op: on the CPU,
or a capture's warm-up), in finalize and the loop optimisations."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    if not hasattr(profiling, "recorded"):
        return None
    counters = profiling.recorded().counters
    graphed = counters.get("pose_graph.graphed_iters", 0)
    n = graphed + counters.get("pose_graph.eager_iters", 0)
    return 100.0 * graphed / n if n else None
