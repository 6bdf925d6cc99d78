"""Multi-device rendering: pixel-grid and sample sharding over a device mesh.

Port of ``voxelraytracing_tpu/parallel/render.py``. The reference scales by
giving every pixel its own GPU thread (SURVEY §2.7 P1/P6); across devices
the same two axes of parallelism are:

  * **rays**: the image's rows are cut into horizontal bands, one a
    device; each traces its band against its own copy of the world. No
    communication until the bands are gathered into the frame.
  * **samples**: independent jittered samples, one a device; their frames
    are summed in sample order and divided by the sample count.

As JAX's ``shard_map`` does, one process drives every device of the mesh
(no ``torch.distributed``): a band's work is queued on its device, so
bands on distinct cards run at once, and bands on one device (a mesh of
``n`` x ``"cuda:0"`` or of ``"cpu"``) run one after another. World tables
are copied once to each distinct device; bands and samples are gathered
on the mesh's first device.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..core.constants import MAX_RAY_STEPS
from ..models.raytracer import RenderSettings, shade_hits
from ..ops.camera import _f32, generate_rays_raw
from ..ops.traverse import WorldSlice, trace_rays


class Mesh(NamedTuple):
    """A ``(samples, rays)`` grid of torch devices (``devices[s, r]``)."""

    devices: np.ndarray
    axis_names: tuple = ("samples", "rays")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(n_samples=1, n_rays=None, devices=None):
    """Build a ``(samples, rays)`` mesh over ``devices`` (default: every
    CUDA card). A device may repeat: ``8 * ["cpu"]`` is the tests' mesh of
    eight CPU devices, ``n * ["cuda:0"]`` splits one card's frame into
    ``n`` bands."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA card (pass devices= to "
                               "mesh other devices)")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if n_rays is None:
        n_rays = len(devices) // n_samples
    if n_samples * n_rays > len(devices) or n_samples * n_rays == 0:
        raise ValueError(f"a {n_samples}x{n_rays} mesh needs that many of "
                         f"the {len(devices)} devices")
    grid = np.empty(n_samples * n_rays, dtype=object)
    grid[:] = devices[: n_samples * n_rays]
    return Mesh(grid.reshape(n_samples, n_rays))


def _replicas(mesh, copy):
    """``copy(device)`` once for each distinct device of the mesh."""
    out = {}
    for d in mesh.devices.reshape(-1):
        if d not in out:
            out[d] = copy(d)
    return out


def _world_on(world, device):
    return WorldSlice(*(x.to(device) for x in world))


def _band_rows(mesh, height, tile=8):
    """The band height of a frame of ``height`` rows over the mesh's
    ``rays`` axis: whole ``tile``-row tiles a band (JAX's assert for the
    v3/v4 frames; the SVO tracer's bands need whole rows)."""
    n_rays = mesh.shape["rays"]
    assert height % (n_rays * tile) == 0, (height, n_rays)
    return height // n_rays


def _gather(mesh, bands):
    """Bands concatenated by rows on the mesh's first device."""
    dev0 = mesh.devices.reshape(-1)[0]
    return torch.cat([b.to(dev0) for b in bands], dim=0)


def _trace_shade(world, materials, origin, dirs, max_steps, settings, wmin):
    s = settings
    rs = trace_rays(world, materials.is_liquid, origin, dirs, max_steps)
    return shade_hits(rs, dirs, origin, materials, s.sky_color, s.sun_pos,
                      s.sun_intensity, wmin, max_steps=max_steps)


class ShardedRayTracer:
    """Primary-ray SVO renderer with the pixel rows banded over a mesh's
    ``rays`` axis: each device traces and shades its band
    (:func:`~..ops.traverse.trace_rays`, :func:`shade_hits`) on its copy of
    the world; the frame is gathered on the mesh's first device, equal to
    :class:`~..models.raytracer.RayTracer`'s unshadowed frame."""

    def __init__(self, materials, mesh, max_steps=None):
        self.materials = materials
        self.mesh = mesh
        self.max_steps = int(max_steps or MAX_RAY_STEPS)

    def render(self, world: WorldSlice, cam, settings=None):
        """``f32[H, W, 3]`` of the camera's frame on the mesh's first
        device."""
        s = settings or RenderSettings()
        w, h = cam.proj_size
        band_h = _band_rows(self.mesh, h, tile=1)
        worlds = _replicas(self.mesh, lambda d: _world_on(world, d))
        wmin = world.world_min.cpu().numpy()
        bands = []
        for r, dev in enumerate(self.mesh.devices[0]):
            origin, dirs = generate_rays_raw(
                cam.inv_view, cam.inv_proj, cam.pos, w, band_h, wmin,
                y0=r * band_h, full_height=h, device=dev)
            bands.append(_trace_shade(worlds[dev], self.materials, origin,
                                      dirs, self.max_steps, s, wmin))
        return _gather(self.mesh, bands)


def sharded_accumulate_step(mesh, materials, width, band_height,
                            max_steps=64):
    """The engine's multi-device frame step: device ``(s, r)`` traces band
    ``r`` through a camera shifted by ``(s / n_samples) * jitter`` on every
    axis, then each band's samples are summed in sample order and divided
    by ``n_samples`` (a 0-d f32 tensor: CUDA turns a division by a host
    scalar into a reciprocal multiply).

    Returns ``step(nodes, chunk_roots, world_min, inv_view, inv_proj,
    cam_pos, jitter_scale) -> f32[band_height * n_rays, width, 3]`` on the
    mesh's first device; the sky and sun are the defaults of the JAX step
    (sky (0.81, 0.93, 1.0), sun at the origin, intensity 4)."""
    n_samples = mesh.shape["samples"]
    n_rays = mesh.shape["rays"]
    full_h = band_height * n_rays
    settings = RenderSettings(sky_color=(0.81, 0.93, 1.0),
                              sun_pos=(0.0, 0.0, 0.0), sun_intensity=4.0)
    f32 = np.float32

    def step(nodes, chunk_roots, world_min, inv_view, inv_proj, cam_pos,
             jitter):
        world = WorldSlice(nodes, chunk_roots,
                           torch.as_tensor(world_min).to(torch.int32))
        worlds = _replicas(mesh, lambda d: _world_on(world, d))
        wmin = world.world_min.cpu().numpy()
        pos = np.asarray(torch.as_tensor(cam_pos).cpu(), f32)
        jit = f32(torch.as_tensor(jitter).cpu())
        bands = []
        for r in range(n_rays):
            acc = None
            for sid in range(n_samples):
                dev = mesh.devices[sid, r]
                eps = (f32(sid) / f32(max(n_samples, 1))) * jit
                origin, dirs = generate_rays_raw(
                    inv_view, inv_proj, pos + eps, width, band_height, wmin,
                    y0=r * band_height, full_height=full_h, device=dev)
                img = _trace_shade(worlds[dev], materials, origin, dirs,
                                   max_steps, settings, wmin)
                img = img.to(mesh.devices[0, r])
                acc = img if acc is None else acc + img
            bands.append(acc / _f32(n_samples, acc.device))
        return _gather(mesh, bands)

    return step


def _grid_replicas(mesh, rg3):
    """The RenderGrid3 copied to each distinct device of the mesh."""
    return _replicas(mesh, lambda d: type(rg3)(
        *(x.to(d) if isinstance(x, torch.Tensor) else x for x in rg3)))


def sharded_render_frame3(mesh, rg3, cam, materials_color, settings=None,
                          rounds=12):
    """Band-sharded v3 frame: each device on the mesh's ``rays`` axis
    traces and shades its band through the v3 round loop
    (:func:`~..ops.wavefront3._render_frame`: ``march3`` a round, then
    ``shade4``) on its copy of the tables. Returns the packed RGBA8
    ``i32[H, W]`` on the mesh's first device, equal to
    :func:`~..ops.wavefront3.render_frame3`'s frame where the band's
    rounds converge."""
    from ..ops.wavefront3 import _frame_row3, _render_frame

    s = settings or RenderSettings()
    _, height = cam.proj_size
    band_h = _band_rows(mesh, height)
    grids = _grid_replicas(mesh, rg3)
    bands = []
    for r, dev in enumerate(mesh.devices[0]):
        rg = grids[dev]
        origin, lut, row = _frame_row3(
            rg, cam, materials_color, sky_color=s.sky_color,
            sun_pos=s.sun_pos, sun_intensity=s.sun_intensity,
            shadow_ambient=s.shadow_ambient, y0=r * band_h)
        img, _, _ = _render_frame(
            rg, origin, cam, lut, row, rounds=int(rounds), sub_rounds=16,
            step_cap=None, shadows=bool(s.shadows), show_steps=False,
            cache_p=None, cache_s=None, compact=True, y0=r * band_h,
            band_height=band_h)
        bands.append(img)
    return _gather(mesh, bands)


def sharded_render_frame4(mesh, rg3, cam, materials_color, settings=None):
    """Band-sharded v4 frame: each device's band runs the split v4 frame
    (:func:`~..ops.wavefront4._render_frame4`: ``touched4`` and
    ``march_planes4`` on the camera rays, the shadow bundle's march with
    shadows, then ``shade4``) on its copy of the packed tables. Returns
    the packed RGBA8 ``i32[H, W]`` on the mesh's first device, equal to
    :func:`~..ops.wavefront4.render_frame4`'s split frame (no step
    heatmap)."""
    from ..ops.wavefront4 import _frame_inputs, _render_frame4, prepare_grid4

    s = settings or RenderSettings()
    _, height = cam.proj_size
    band_h = _band_rows(mesh, height)
    grids = _grid_replicas(mesh, rg3)
    prepared = {d: prepare_grid4(g) for d, g in grids.items()}
    bands = []
    for r, dev in enumerate(mesh.devices[0]):
        row, args, kw = _frame_inputs(
            grids[dev], cam, materials_color, sky_color=s.sky_color,
            sun_pos=s.sun_pos, sun_intensity=s.sun_intensity,
            shadow_ambient=s.shadow_ambient, show_steps=False,
            shadows=bool(s.shadows), rounds=64, steps_per_round=128,
            step_cap=None, prepared=prepared[dev], y0=r * band_h,
            band_height=band_h)
        bands.append(_render_frame4(row, *args, **kw)[0])
    return _gather(mesh, bands)
