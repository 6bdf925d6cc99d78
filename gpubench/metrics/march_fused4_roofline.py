"""The march_fused4 launches' share of their roofline: the least time of the
work the reference's march found in the compared frames
(gpubench/roofline.py) over the device time of those frames' march_fused4
launches in the traced window."""

import sys

from gpubench import roofline

KERNEL = "march_fused4"


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.works:
        return None
    dev = t.frame_ms(KERNEL + "_kernel", [w.frame for w in ctx.works])
    if dev is None:
        return None
    pairs = [(roofline.kernel_least(KERNEL, w), d) for w, d in zip(ctx.works, dev)
             if d is not None]
    if not pairs or sum(d for _, d in pairs) <= 0:
        return None
    least = sum(x[0] for x, _ in pairs)
    print(f"{KERNEL}: least {least / len(pairs):.6f} ms a frame (bound by "
          f"{pairs[0][0][1]}), device {sum(d for _, d in pairs) / len(pairs):.6f} ms, "
          f"{len(pairs)} frames", file=sys.stderr)
    return 100.0 * least / sum(d for _, d in pairs)
