"""The window's time (its start to the last frame's completion, CUDA events
on the stream) over the frames completed in it."""


def read(ctx):
    return ctx.window_ms / ctx.frames
