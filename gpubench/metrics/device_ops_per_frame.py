"""Kernels and copies a frame on the card, in the traced window."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    return len(t.device) / t.frames
