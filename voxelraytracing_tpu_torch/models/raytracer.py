"""The primary ray tracer's user-facing surface.

Port of ``RenderSettings``, ``WavefrontRenderer.render_packed`` and
``to_srgb8`` from ``voxelraytracing_tpu/models/raytracer.py``. The
renderer draws every frame through the fused v4 frame
(:func:`~..ops.wavefront4.render_frame4` with ``fused=True``): in the JAX
package its v3/v4 and split/fused paths are bit-identical
(tests/test_wavefront4.py), so one path serves them all.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.camera import CamData

STEP_CAP = 500  # per-ray step budget (ray_tracer.wgsl:220)
STEPS_PER_ROUND = 48  # sets the show_step_count heatmap scale, as in JAX


@dataclass(frozen=True)
class RenderSettings:
    """Dynamic per-frame settings (reference defaults:
    clientdesktop/src/main.rs:153-156)."""

    sun_intensity: float = 4.0
    sky_color: tuple = (0.81, 0.93, 1.0)
    sun_pos: tuple = (0.0, 0.0, 0.0)
    max_ray_bounces: int = 3
    show_step_count: bool = False
    shadows: bool = False
    shadow_ambient: float = 0.4  # light retained in shadowed areas


def to_srgb8(img):
    """Linear f32 frame -> uint8 RGB on the host (the rgba8unorm store
    clamps identically)."""
    img = torch.as_tensor(img)
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


class WavefrontRenderer:
    """Flagship fast-path renderer over a
    :class:`~..ops.wavefront3.RenderGrid3`: one fused launch per frame
    (march + in-kernel shade) emitting packed RGBA8, with the JAX
    renderer's v4 defaults: the reference kernel's 500-step cap
    (ray_tracer.wgsl:220) and a step heatmap scaled for 48 steps a round.
    """

    def __init__(self, materials, show_step_count=False):
        self.materials = materials
        self.show_step_count = bool(show_step_count)
        # warm token of the last frame, keyed by frame size (inert on
        # Hopper, carried so the API matches the JAX renderer)
        self._cache = None
        self._cache_size = None
        # packed tables (prepare_grid4), keyed on grid identity
        self._prepared = None
        self._prepared_for = None

    def render_packed(self, rgrid3, cam: CamData,
                      settings: RenderSettings = None):
        """One frame -> ``int32[H,W]`` packed RGBA8 on the grid's device."""
        from ..ops.wavefront4 import prepare_grid4, render_frame4

        s = settings or RenderSettings()
        cache = (self._cache if self._cache_size == tuple(cam.proj_size)
                 else None)
        # RenderGrid3 is an immutable NamedTuple, so any world change
        # produces a new tuple and re-packs once
        if self._prepared_for is not rgrid3:
            self._prepared = prepare_grid4(rgrid3)
            self._prepared_for = rgrid3
        img, tok = render_frame4(
            rgrid3, cam, np.asarray(self.materials.color),
            sky_color=s.sky_color, sun_pos=s.sun_pos,
            sun_intensity=s.sun_intensity, shadows=s.shadows,
            shadow_ambient=s.shadow_ambient,
            show_steps=self.show_step_count,
            steps_per_round=STEPS_PER_ROUND, step_cap=STEP_CAP,
            cache=cache, return_cache=True,
            prepared=self._prepared, fused=True,
        )
        self._cache = tok
        self._cache_size = tuple(cam.proj_size)
        return img
