"""Device ms a frame in kernels and copies that are not the program's
hand-written CUDA kernels (torch's own ops: the leg-end glue, table and
scalar uploads, the frame's other torch ops)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return ctx.trace.ops_ms(ctx.kernels) / ctx.trace.frames
