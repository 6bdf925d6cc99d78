"""The primary ray tracers' user-facing surface.

Port of ``voxelraytracing_tpu/models/raytracer.py``: ``RenderSettings``,
``shade_hits``, the SVO :class:`RayTracer`, ``to_srgb8``,
``composite_crosshair`` and ``WavefrontRenderer`` (``render``,
``render_packed``). :class:`RayTracer` marches the SVO node pool
(:func:`~..ops.traverse.trace_rays`, torch on the device of the world's
tensors) and shades with :func:`shade_hits`, with an optional hard-shadow
pass. The fast renderer routes frames as
the JAX one does: on a :class:`~..ops.wavefront3.RenderGrid3`,
``tracer="v4"`` draws the split v4 frame
(:func:`~..ops.wavefront4.render_frame4`, ``fused=False``), any other
tracer the v3 frame (:func:`~..ops.wavefront3.render_frame3`) at
``v3_rounds`` service rounds; on a v1
:class:`~..ops.wavefront.RenderGrid`, ``render`` marches the v2 frame
(:func:`~..ops.wavefront2.trace_wavefront2`) and shades it with
:func:`shade_hits`.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..core.constants import MAX_RAY_STEPS, RAY_EPS
from ..ops.camera import CamData, _f32, generate_rays_raw, sqrt_rn
from ..ops.sky import ray_sky
from ..ops.traverse import TraceResult, WorldSlice, trace_rays

STEP_CAP = 500  # per-ray step budget (ray_tracer.wgsl:220)
STEPS_PER_ROUND = 48  # sets the show_step_count heatmap scale, as in JAX
TRACERS = ("v1", "v2", "v4")
WATER_OVERLAY_COLOR = (0.2, 0.5, 1.0)
# v2 progress is bounded by cache-service rounds, not steps: render gives
# it the renderer's full round count at this per-round step budget (48
# rounds x 24 steps covers the reference's 500-step cap,
# ray_tracer.wgsl:220, with service headroom)
V2_STEPS_PER_ROUND = 24


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


def shade_hits(rs: TraceResult, dirs, origin, materials, sky_color, sun_pos,
               sun_intensity, world_min, show_step_count=False,
               max_steps=MAX_RAY_STEPS):
    """Composite a traced frame into linear RGB f32[..., 3] on the device of
    ``dirs`` (ray_tracer.wgsl:131-157, 291-316): face tints, the step
    heatmap, the sky where nothing was hit, the water overlay."""
    dev = dirs.device
    table = torch.as_tensor(np.asarray(materials.color, np.float32)).to(dev)
    color = table[rs.voxel.long()]
    # face tints: X faces x0.5, Z faces x0.7, bottom faces x0.2
    color = torch.where((rs.norm[..., 0] != 0.0)[..., None], color * 0.5,
                        color)
    color = torch.where((rs.norm[..., 2] != 0.0)[..., None], color * 0.7,
                        color)
    color = torch.where((rs.norm[..., 1] == -1.0)[..., None], color * 0.2,
                        color)
    if show_step_count:
        f = torch.clamp(rs.steps.to(torch.float32) / _f32(max_steps, dev),
                        0.0, 1.0)
        color = f[..., None].expand(color.shape)

    sky = ray_sky(dirs, origin, sky_color, sun_pos, sun_intensity, world_min)
    out = torch.where(rs.hit[..., None], color, sky)

    # water overlay (ray_tracer.wgsl:137-141)
    factor = torch.clamp(rs.water_dist / _f32(14.0, dev), 0.8, 1.0)
    overlay = torch.tensor(WATER_OVERLAY_COLOR, dtype=torch.float32).to(dev)
    wet = (rs.water_dist != 0.0)[..., None]
    return torch.where(
        wet, out * (1.0 - factor[..., None]) + overlay * factor[..., None],
        out)


class RayTracer:
    """Flagship SVO renderer: primary rays + face shading (+ optional hard
    shadows), on the device of the world's tensors."""

    def __init__(self, materials, show_step_count=False, shadows=False,
                 max_steps=MAX_RAY_STEPS):
        self.materials = materials
        self.show_step_count = bool(show_step_count)
        self.shadows = bool(shadows)
        self.max_steps = int(max_steps)

    def render(self, world: WorldSlice, cam: CamData,
               settings: RenderSettings = None):
        """Render one frame; returns ``(f32[H,W,3] image, TraceResult)``.

        ``settings.shadows`` enables the shadow pass per frame on top of the
        constructor default; ``settings.shadow_ambient`` sets how much light
        shadowed surfaces keep."""
        s = settings or RenderSettings()
        w, h = cam.proj_size
        dev = world.nodes.device
        wmin = world.world_min.cpu().numpy()
        origin, dirs = generate_rays_raw(cam.inv_view, cam.inv_proj, cam.pos,
                                         w, h, wmin, device=dev)
        mats = self.materials
        rs = trace_rays(world, mats.is_liquid, origin, dirs, self.max_steps)
        img = shade_hits(rs, dirs, origin, mats, s.sky_color, s.sun_pos,
                         s.sun_intensity, wmin,
                         show_step_count=self.show_step_count,
                         max_steps=self.max_steps)
        if self.shadows or s.shadows:
            # Hard shadows: one occlusion ray from each hit point toward the
            # sun; shadowed surfaces keep ``shadow_ambient`` of their light.
            sun_vec = (torch.tensor(s.sun_pos, dtype=torch.float32).to(dev)
                       - world.world_min.to(torch.float32) - rs.pos)
            sq = sun_vec * sun_vec
            n = sqrt_rn((sq[..., 0] + sq[..., 1]) + sq[..., 2])
            sun_dir = sun_vec / n[..., None]
            shadow_org = rs.pos + rs.norm * (4.0 * RAY_EPS)
            srs = trace_rays(world, mats.is_liquid, shadow_org, sun_dir,
                             self.max_steps)
            shadowed = rs.hit & srs.hit
            amb = float(np.float32(s.shadow_ambient))
            img = torch.where(shadowed[..., None], img * amb, img)
        return img, rs


def to_srgb8(img):
    """Linear f32 frame -> uint8 RGB on the host (the rgba8unorm store
    clamps identically)."""
    img = torch.as_tensor(img)
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


def composite_crosshair(img, style="cross", size=8.0,
                        color=(1.0, 1.0, 1.0, 0.8)):
    """Blend a dot/cross crosshair over the screen center of an f32
    ``[H, W, 3]`` frame, on its device.

    The blit-stage fragment math of screen_shader.wgsl:43-65: mask = 1 inside
    the shape (dot: dist < size; cross: two axis-aligned bars of half-width
    size/4), scaled by color alpha; out = img*(1-mask) + color.rgb*mask.
    ``style`` is "off" | "dot" | "cross".
    """
    if style in (None, "off", 0):
        return img
    h, w = img.shape[:2]
    cy, cx = h * 0.5, w * 0.5
    dev = img.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    dy = (ys - cy).abs()
    dx = (xs - cx).abs()
    if style in ("dot", 1):
        mask = (sqrt_rn(dx * dx + dy * dy) < size).to(torch.float32)
    else:  # cross
        bar = size * 0.25
        mask = (((dx < size) & (dy < bar))
                | ((dy < size) & (dx < bar))).to(torch.float32)
    mask = (mask * float(np.float32(color[3])))[..., None]
    rgb = torch.tensor(color[:3], dtype=img.dtype).to(dev)
    return img * (1.0 - mask) + rgb * mask


class WavefrontRenderer:
    """Fast-path renderer with the JAX renderer's constructor and routing.

    :meth:`render_packed` (a :class:`~..ops.wavefront3.RenderGrid3`: the
    march, an optional hard-shadow pass and the shade, emitting packed
    RGBA8): ``tracer="v4"`` draws the split v4 frame at its default 64
    rounds; any other tracer (the default ``"v2"``, or ``"v1"``) the v3
    route, ``render_frame3`` at ``v3_rounds`` service rounds, warm-started
    from the last v3 frame of the same size. Both march under
    ``v3_step_cap`` (the reference kernel's 500-step cap,
    ray_tracer.wgsl:220) and scale the step heatmap to ``rounds *
    (v3_steps_per_round // 8) * 8``.

    :meth:`render` returns an f32 image: a RenderGrid3 goes through
    :meth:`render_packed`; a v1 :class:`~..ops.wavefront.RenderGrid`
    through the v2 march (``tracer="v2"``: ``max_rounds`` rounds of 24
    steps) or, for every other tracer, the v1 tracer
    (:func:`~..ops.wavefront.trace_wavefront`: ``max_rounds`` rounds of
    ``inner_steps`` steps), then :func:`shade_hits`, whose heatmap scale
    is ``max_rounds * inner_steps``.
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

    def _shade(self, wf, dirs, origin, world_min, s):
        """Shade a v1 or v2 trace (the JAX renderer's ``_shade_impl``)."""
        pos = origin[None, None] + dirs * wf.t[..., None]
        rs = TraceResult(hit=wf.hit, voxel=wf.voxel, norm=wf.norm, pos=pos,
                         water_dist=wf.water_dist, steps=wf.steps)
        return shade_hits(rs, dirs, origin, self.materials, s.sky_color,
                          s.sun_pos, s.sun_intensity, world_min,
                          show_step_count=self.show_step_count,
                          max_steps=self.max_rounds * self.inner_steps)

    def render(self, rgrid, cam: CamData, settings: RenderSettings = None):
        """One frame -> ``(f32[H,W,3] image, trace result)`` on the grid's
        device.

        With a RenderGrid3 the trace result is the packed RGBA8 frame of
        :meth:`render_packed` and the image is unpacked from it. With a v1
        RenderGrid it is the :class:`~..ops.wavefront.WavefrontResult` of
        the v2 march or of the v1 tracer."""
        from ..ops.wavefront import trace_wavefront
        from ..ops.wavefront2 import trace_wavefront2
        from ..ops.wavefront3 import RenderGrid3

        s = settings or RenderSettings()
        if isinstance(rgrid, RenderGrid3):
            packed = self.render_packed(rgrid, cam, s)
            img = torch.stack([(packed >> sh) & 0xFF for sh in (0, 8, 16)],
                              dim=-1).to(torch.float32)
            return img / _f32(255.0, img.device), packed
        w, h = cam.proj_size
        dev = rgrid.bwin.device
        # the directions do not depend on world_min; the origin is
        # cam.pos - world_min in f32, computed on the card
        _, dirs = generate_rays_raw(cam.inv_view, cam.inv_proj, cam.pos, w, h,
                                    np.zeros(3, np.float32), device=dev)
        origin = (torch.as_tensor(np.asarray(cam.pos, np.float32)).to(dev)
                  - rgrid.world_min.to(torch.float32))
        if self.tracer == "v2":
            wf = trace_wavefront2(rgrid, origin, dirs, width=w, height=h,
                                  rounds=self.max_rounds,
                                  steps_per_round=V2_STEPS_PER_ROUND)
        else:
            wf = trace_wavefront(rgrid, origin, dirs, width=w, height=h,
                                 max_rounds=self.max_rounds,
                                 inner_steps=self.inner_steps)
        return self._shade(wf, dirs, origin, rgrid.world_min, s), wf
