"""The least time a frame's work can take on one H100, from the work the
reference's march found (its steps, rays and the table rows it read),
never from a counter the program reports: a redesigned kernel is read
against the same work.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM and 67 TFLOP/s of
FP32 outside the tensor cores (the march is FP32 and integer work). The
least time is the larger of operations over the FP32 peak and bytes over
the HBM peak; each input byte counts once and each output byte once.

Operations, FP32 only (integer index arithmetic is not counted, a
transcendental counts as one):

* a march step: the position (3 multiplies, 3 adds), its floor (3), the
  exit along each axis (sign, scale to the cell, floor, +1, back to
  voxels, minus the position, times the inverse direction: 7 x 3), the
  least exit (2 minimums) and the advance (2 adds): 34;
* a ray's set-up: inverse directions, signs and the slab exit: 20;
* a camera ray: the unprojection and normalisation: 25;
* the raster shade: tints, sky, sun, water, bytes: 50;
* a path's leg end: water absorption, sky with the sun, emission and
  albedo, and the scatter (draws, Box-Muller, normal, mirror, mix,
  normalisations, origin): 130.

Bytes: the rows the march read (a subwindow's content row, 7 x 128
words, for each distinct subwindow whose bricks or voxels a step looked
at; a window's meta row, 128 words, for each distinct window whose
subwindows it looked at), and each per-pixel input and output once.
"""

HBM_BPS = 3.35e12
FP32_OPS = 67e12
OPS_STEP = 34
OPS_RAY = 20
OPS_CAMERA = 25
OPS_SHADE = 50
OPS_LEG_END = 130
ROW_BYTES = 7 * 128 * 4
WINDOW_BYTES = 128 * 4
RASTER_OUT = 8          # packed RGBA8 and the flags word a pixel
PLANES_OUT = 16         # t, flags, water, water entry a pixel
BUNDLE_IN = 25          # origin, direction, active a pixel
RADIANCE_OUT = 12       # f32 RGB a pixel


def least_ms(ops, nbytes):
    """(least ms, what bounds it)."""
    t_o, t_b = ops / FP32_OPS * 1e3, nbytes / HBM_BPS * 1e3
    return (t_o, "operations") if t_o >= t_b else (t_b, "bytes")


def frame_ops(kind, work):
    """FP32 operations of one frame's work."""
    ops = 0
    for i, leg in enumerate(work.legs):
        ops += leg["steps"] * OPS_STEP + leg["rays"] * OPS_RAY
        if i == 0:
            ops += leg["pixels"] * OPS_CAMERA
        ops += leg["pixels"] * OPS_SHADE if kind == "raster" else leg["rays"] * OPS_LEG_END
    return ops


def _rows(leg):
    return leg["rows"] * ROW_BYTES + leg["windows"] * WINDOW_BYTES


def kernel_least(kernel, work):
    """(least ms, bound) of the launches of ``kernel`` in one frame."""
    legs = work.legs
    if kernel == "march_fused4":
        return least_ms(frame_ops("raster", work), _rows(legs[0]) + legs[0]["pixels"] * RASTER_OUT)
    if kernel == "march_planes4":
        ops = sum(l["steps"] * OPS_STEP + l["rays"] * OPS_RAY for l in legs) \
            + legs[0]["pixels"] * OPS_CAMERA
        nbytes = sum(_rows(l) + l["pixels"] * PLANES_OUT for l in legs) \
            + sum(l["pixels"] * BUNDLE_IN for l in legs[1:])
        return least_ms(ops, nbytes)
    if kernel == "pt4":
        # one launch: the rows of the leg that read the most, a lower bound
        # on the distinct rows of all its legs
        return least_ms(frame_ops("path", work),
                        max(_rows(l) for l in legs) + legs[0]["pixels"] * RADIANCE_OUT)
    raise ValueError(kernel)
