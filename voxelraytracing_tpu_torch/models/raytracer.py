"""The primary ray tracer's user-facing surface.

Port of ``RenderSettings``, ``WavefrontRenderer.render_packed`` and
``to_srgb8`` from ``voxelraytracing_tpu/models/raytracer.py``. The renderer
routes frames as the JAX one does: ``tracer="v4"`` draws the split v4 frame
(:func:`~..ops.wavefront4.render_frame4`, ``fused=False``), any other
tracer the v3 frame (:func:`~..ops.wavefront3.render_frame3`) at
``v3_rounds`` service rounds.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.camera import CamData

STEP_CAP = 500  # per-ray step budget (ray_tracer.wgsl:220)
STEPS_PER_ROUND = 48  # sets the show_step_count heatmap scale, as in JAX
TRACERS = ("v1", "v2", "v4")


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
    """Fast-path renderer over a :class:`~..ops.wavefront3.RenderGrid3`:
    the march, an optional hard-shadow pass and the shade, emitting packed
    RGBA8, with the JAX renderer's constructor and routing.

    ``tracer="v4"``: the split v4 frame at its default 64 rounds. Any other
    tracer (the default ``"v2"``, or ``"v1"``): the v3 route,
    ``render_frame3`` at ``v3_rounds`` service rounds, warm-started from
    the last v3 frame of the same size. Both routes march under
    ``v3_step_cap`` (the reference kernel's 500-step cap,
    ray_tracer.wgsl:220) and scale the step heatmap to ``rounds *
    (v3_steps_per_round // 8) * 8``. ``max_rounds`` and ``inner_steps``
    set the heatmap of the v1 ``render`` path, which is not ported; they
    are kept for the signature.
    """

    def __init__(self, materials, show_step_count=False, max_rounds=48,
                 inner_steps=12, tracer="v2", v3_rounds=16,
                 v3_steps_per_round=STEPS_PER_ROUND, v3_step_cap=STEP_CAP):
        if tracer not in TRACERS:
            raise ValueError(f"unknown tracer {tracer!r}")
        self.materials = materials
        self.show_step_count = bool(show_step_count)
        self.max_rounds = int(max_rounds)
        self.inner_steps = int(inner_steps)
        self.tracer = tracer
        self.v3_rounds = int(v3_rounds)
        self.v3_steps_per_round = int(v3_steps_per_round)
        self.v3_step_cap = None if v3_step_cap is None else int(v3_step_cap)
        # warm token of the last frame, keyed as JAX keys it: the v3 route
        # on the frame size (it steers the v3 service), the v4 route on
        # ("v4",) + frame size (inert on Hopper)
        self._cache = None
        self._cache_size = None
        # packed tables (prepare_grid4), keyed on grid identity
        self._prepared = None
        self._prepared_for = None

    def render_packed(self, rgrid3, cam: CamData,
                      settings: RenderSettings = None):
        """One frame -> ``int32[H,W]`` packed RGBA8 on the grid's device."""
        from ..ops.wavefront3 import render_frame3
        from ..ops.wavefront4 import prepare_grid4, render_frame4

        s = settings or RenderSettings()
        v4 = self.tracer == "v4"
        key = (("v4",) if v4 else ()) + tuple(cam.proj_size)
        cache = self._cache if self._cache_size == key else None
        kw = dict(sky_color=s.sky_color, sun_pos=s.sun_pos,
                  sun_intensity=s.sun_intensity, shadows=s.shadows,
                  shadow_ambient=s.shadow_ambient,
                  show_steps=self.show_step_count,
                  steps_per_round=self.v3_steps_per_round,
                  step_cap=self.v3_step_cap, cache=cache, return_cache=True)
        color = np.asarray(self.materials.color)
        if v4:
            # RenderGrid3 is an immutable NamedTuple, so any world change
            # produces a new tuple and re-packs once
            if self._prepared_for is not rgrid3:
                self._prepared = prepare_grid4(rgrid3)
                self._prepared_for = rgrid3
            img, tok = render_frame4(rgrid3, cam, color,
                                     prepared=self._prepared, fused=False,
                                     **kw)
        else:
            img, tok = render_frame3(rgrid3, cam, color,
                                     rounds=self.v3_rounds, **kw)
        self._cache = tok
        self._cache_size = key
        return img
