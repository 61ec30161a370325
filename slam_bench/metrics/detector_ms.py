"""ms a chunk in the batched detector the evaluator holds, timed by the
benchmark with a synchronisation around each call."""

from slam_bench.harness.readers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "detector", per="chunk")
