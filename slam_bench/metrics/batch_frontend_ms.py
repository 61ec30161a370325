"""ms a round in the batched front end (upload, make_multi_chunk_frontend,
fetch_many), host clock with a synchronisation."""

from slam_bench.harness.readers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "batch_frontend")
