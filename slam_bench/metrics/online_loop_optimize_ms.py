"""ms a loop in applying it: the read of the loop's edge, the edge added
and the pose graph's 10 LM iterations at 4,096 nodes and 8,192 edges:
the program's span `online.loop_optimize`
(utils.profiling.recorded()), synchronised at its end in traced runs."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    if not hasattr(profiling, "recorded"):
        return None
    spans = [t1 - t0 for n, _, t0, t1 in profiling.recorded().spans
             if n == "online.loop_optimize" and t1 is not None]
    return 1e3 * sum(spans) / len(spans) if spans else None
