"""The comparison that decides ``correct``: the frames the timed path made
against the reference's frames of the same inputs.

A frame's number is the share of its pixels that the reference does not
bear out (``px_off_pct``, percent): for a raster frame, a pixel any of
whose colour bytes differs by more than 2 (of 255); for a radiance frame,
a pixel that is not finite or any of whose channels differs by more than
2/255 plus 1% of the reference's value. Rays that graze a voxel's edge or
corner can land on another face or voxel when the two sides' arithmetic
differs by an ulp, and a path that scatters from there differs from then
on, so a few pixels off is rounding; a fault or a lower precision moves a
large share. The cell's number is its worst frame's.
"""

import torch

RASTER_BYTES = 2
RADIANCE_ABS = 2.0 / 255.0
RADIANCE_REL = 0.01


def raster_off_pct(img, ref):
    """``img`` int32 [H, W] RGBA8 words (the program's) or uint8 [H, W, 4]
    (the control's), ``ref`` uint8 [H, W, 4]."""
    if img.dim() == 2:
        p = img.to(torch.int64) & 0xFFFFFFFF
        img = torch.stack([(p >> (8 * c)) & 0xFF for c in range(4)], dim=-1)
    if tuple(img.shape) != tuple(ref.shape):
        return 100.0
    diff = (img.to(torch.int64) - ref.to(torch.int64)).abs().amax(dim=-1)
    return float((diff > RASTER_BYTES).double().mean()) * 100.0


def radiance_off_pct(img, ref):
    """``img``, ``ref``: float [H, W, 3] radiance."""
    if tuple(img.shape) != tuple(ref.shape):
        return 100.0
    img, ref = img.double(), ref.double()
    bad = ~torch.isfinite(img).all(dim=-1) | (
        (img - ref).abs() > RADIANCE_ABS + RADIANCE_REL * ref.abs()).any(dim=-1)
    return float(bad.double().mean()) * 100.0


def off_pct(kind, out, ref):
    return (raster_off_pct if kind == "raster" else radiance_off_pct)(out, ref)
