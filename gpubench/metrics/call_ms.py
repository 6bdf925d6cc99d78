"""Host ms inside each frame call, the wait at the program's own sync
included (the harness's span around the call; the mean over the frames the
profiler did not record)."""


def read(ctx):
    return float(ctx.calls_ms.mean()) if len(ctx.calls_ms) else None
