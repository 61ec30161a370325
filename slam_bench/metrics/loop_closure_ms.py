"""ms a chunk in loop closure: the query, the batched verify and the
pose-graph optimisation (the program's StageTimer spans)."""

from slam_bench.harness.readers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "loop_query", "loop_verify", "loop_optimize", per="chunk")
