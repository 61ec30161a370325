"""ms a round on the host chain and the gyro priors of the round."""

from slam_bench.harness.readers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "chain")
