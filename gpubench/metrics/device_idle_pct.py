"""Share of a frame's time in which no kernel or copy ran on the card: the
device's busy time a frame in the traced window (the union of its kernels
and copies) over the mean completion interval of the frames the profiler
did not record, whose host is not slowed by the profiler."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device or ctx.frame_ms_untraced <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() * 1e3 / t.frames / ctx.frame_ms_untraced)
