"""frame_p95_ms of a cell the host paces (the card idle over half the
time): the 95th percentile of the intervals between consecutive frames'
completion events, over the frames the profiler did not record."""

import numpy as np


def read(ctx):
    x = ctx.intervals_untraced_ms
    return float(np.percentile(x, 95)) if len(x) else None
