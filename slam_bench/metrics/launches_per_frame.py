"""Kernels, copies and sets on the device in the traced window, over the
sequence-frames of the window."""


def read(ctx):
    return ctx["device"]["launches"] / ctx["frames"] if ctx["frames"] else None
