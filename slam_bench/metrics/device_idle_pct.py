"""100 minus the share of the traced window in which the device ran a
kernel, copy or set (the union of their intervals)."""


def read(ctx):
    d = ctx["device"]
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"]) if d["window_s"] > 0 else None
