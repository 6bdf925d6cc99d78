"""The 95th percentile, over every frame of the window, of the interval
between consecutive frames' completion events (the first frame's from the
window's start): the stutter a player sees."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.intervals_ms, 95))
