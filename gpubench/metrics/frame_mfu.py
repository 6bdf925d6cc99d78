"""The frame's FP32 work (the operations of the reference's march and leg
ends, gpubench/roofline.py) over what the card's FP32 peak does in one
frame's time (the mean completion interval of the frames the profiler did
not record)."""

import numpy as np

from gpubench import roofline


def read(ctx):
    if not ctx.works or ctx.frame_ms_untraced <= 0:
        return None
    ops = np.mean([roofline.frame_ops(ctx.kind, w) for w in ctx.works])
    return 100.0 * ops / roofline.FP32_OPS / (ctx.frame_ms_untraced / 1e3)
