"""90th percentile (ms) of the host time of every chunk of the window."""

import numpy as np


def read(ctx):
    v = ctx["spans"].get("chunk")
    return float(np.percentile(np.asarray(v) * 1e3, 90)) if v else None
