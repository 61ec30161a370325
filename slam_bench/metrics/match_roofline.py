"""Share (%) of the match kernel's least time (from the window's shapes and
data) in its device time by name in the trace."""

from slam_bench.harness.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "match")
