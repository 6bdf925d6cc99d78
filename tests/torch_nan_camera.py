"""A camera with no basis, for the port's tests: its inverse view's
rotation zeroed, so every camera ray's direction is 0/0 (NaN). No ray
steps, and JAX's frame packs every pixel to ``NAN_SKY``: a NaN sky is
byte 0 in every channel, as XLA converts NaN to an integer."""

import dataclasses

NAN_SKY = 0xFF000000  # the packed word (as uint32) of every pixel


def zero_basis(cam):
    """``cam``, either package's ``CamData``, with its basis zeroed."""
    iv = cam.inv_view.copy()
    iv[:3, :3] = 0.0
    return dataclasses.replace(cam, inv_view=iv)
