"""ms a chunk in the chunked evaluator's front end (extract, pairs, the
batched detector): the program's StageTimer span "frontend"."""

from slam_bench.harness.readers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "frontend", per="chunk")
