"""ms a sequence in ChunkedSlam.finalize, host clock with a synchronisation."""

from slam_bench.harness.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "finalize")
