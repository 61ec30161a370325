"""ms a chunk in chunk BA, the IMU metric scale, the state update and
the backbone edges: the program's StageTimer spans."""

from slam_bench.harness.readers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "chunk_ba", "imu_scale", "state_update", "backbone_edges", per="chunk")
