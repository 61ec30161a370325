"""The whole step's share (%) of the chip's peak: the least time of the
counted work (the three kernels' bounds, rBRIEF's least work (counts.
brief_least_s), the detector's convolutions at bf16) over the traced
window."""

from slam_bench.harness.readers import step_least_s


def read(ctx):
    least = step_least_s(ctx)
    w = ctx["device"]["window_s"]
    return None if least is None or w <= 0 else 100.0 * least / w
