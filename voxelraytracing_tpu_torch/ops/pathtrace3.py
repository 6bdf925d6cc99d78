"""Path tracing on the v4 march or the v3 round loop: ``path_trace3`` /
``path_trace4``.

Port of both routes of ``voxelraytracing_tpu/ops/wavefront3.py``
(``_path_frame`` :2389, ``path_trace3`` :3046) and of
``voxelraytracing_tpu/ops/wavefront4.py:path_trace4`` (:2651), and of the
material-fetch kernel ``wavefront3.py:_mat_kernel`` (:2306, launched by
``_matfetch`` :2332).

A frame marches its camera rays once (the state-plane march,
:func:`~.wavefront4.march_planes4`), then, for every sample, walks its
legs: at each leg's end it fetches the hit materials (:func:`matfetch4`),
attenuates the path through water (Beer-Lambert), adds the sky to rays
that missed and the emission of hit voxels, and, with bounces left,
scatters the hit rays about the face normal and marches them again as a
per-ray bundle. The per-ray draws are a murmur3 counter hash of the tiled
ray id; only the 2-word key of each sample and bounce comes from
Threefry (:mod:`.prng`), so the draws equal the JAX package's.

On the v4 route the JAX legs are capped at ``rounds`` serve rounds and
can resume stragglers (``bounce_rounds``, ``compact_tiles`` and the other
knobs of :data:`SCHEDULE_KNOBS`): TPU schedule, bit-exact against the
uncapped leg when its capacities cover the population
(tests/test_pathtrace4.py). The port marches every v4 leg to its end,
which is that uncapped leg. On the v3 route (``v4=False``) each leg runs
the v3 round loop (:func:`~.wavefront3._trace_frame`), whose round budget
decides which rays finish, as in JAX.

The leg-end math (:func:`_leg_shade`, :func:`_bounce_rays`) is shared
with the one-launch path tracer's plain version
(:func:`~.pathtrace4.pt4_ref`), in one op order; the CUDA kernel
``csrc/pathtrace4.cu`` follows it too.
"""

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from . import prng
from .camera import sqrt_rn
from .wavefront import TILE_H, TILE_W
from .wavefront3 import (
    _BLK,
    _FL_AX,
    _FL_HIT,
    _FL_VOX,
    SB_H,
    SB_W,
    _sb_dims,
    material_lut_rows,
)
from .wavefront4 import (
    PreparedGrid4Sparse,
    _camera_rays,
    _check,
    _device_of,
    _frame_dims,
    _inv_dir,
    _pixels,
    _run,
    _scal_row,
    _slab_exit,
    _tables,
    _token,
    march_planes4,
)

_WATER_ABSORB = (0.35, 0.08, 0.04)  # per voxel length
_EPS_N = float(np.float32(4.0 * 1e-3))  # bounce-origin nudge along the normal
_TWO_PI = float(np.float32(2.0 * np.pi))
_GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF

# TPU schedule knobs the repository's callers pass to the JAX path_trace3
# (benchmarks/run.py, tools/tpu_correctness.py, tests/test_pathtrace4.py,
# tests/test_wavefront4.py): serve budgets, leg caps and straggler resume,
# sorts and re-binning. None changes a converged frame; the port accepts
# and ignores them, except ``prim_steps_per_round``, which on JAX's v3
# route sets the sub-rounds of every leg.
SCHEDULE_KNOBS = frozenset({
    "bounce_steps_per_round", "prim_steps_per_round", "prim_s_seg",
    "prim_rounds", "prim_compact", "bounce_rounds", "compact_tiles",
    "compact_lanes", "retry_rounds1", "compact_tiles2", "bounce_sort",
    "bounce_rebin", "bounce_wm_full", "bounce_spin_ramp",
})


# ------------------------------------------------------------ material fetch


class Materials(NamedTuple):
    """Per-ray material planes of a leg's hit ids."""

    emission: torch.Tensor
    scatter: torch.Tensor
    r: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor


def _mat_rows(mlut, vox):
    """Material planes of hit ids ``vox``: channel ``k`` of id ``v`` is
    ``mlut`` flat word ``k*256 + v`` (row pair ``2k, 2k+1``)."""
    flat = mlut.reshape(-1)
    v = vox.long()
    return Materials(*(flat[k * 256 + v] for k in range(5)))


def matfetch4_ref(fl, mlut):
    """Plain PyTorch version of the material fetch
    (wavefront3.py:_mat_kernel): the hit id of each flags word (bits
    17-24) -> emission, scatter, r, g, b from the f32[10,128] LUT
    (:func:`~.wavefront3.material_lut_rows`), each of ``fl``'s shape."""
    return _mat_rows(mlut, (fl >> _FL_VOX) & 0xFF)


def matfetch4(fl, mlut):
    """Material fetch -> :class:`Materials`, each f32 of ``fl``'s shape.

    On CUDA tensors: one launch of ``csrc/matfetch4.cu``; on CPU tensors:
    the plain version :func:`matfetch4_ref`. Any other device raises.
    ``fl`` is an int32 flags plane, ``mlut`` the f32[10,128] LUT."""
    dev = _device_of(fl, "matfetch4")
    if dev.type == "cpu":
        return matfetch4_ref(fl, mlut)
    _check(dev, [("fl", fl, torch.int32, tuple(fl.shape)),
                 ("mlut", mlut, torch.float32, (10, 128))])
    out = torch.empty((5,) + tuple(fl.shape), dtype=torch.float32,
                      device=dev)
    _run(dev, "matfetch4", _build.load("matfetch4").matfetch4_launch,
         mlut.data_ptr(), fl.data_ptr(), out.data_ptr(), fl.numel())
    matfetch4.launches += 1
    return Materials(*out.unbind(0))


matfetch4.launches = 0  # kernel launches since the last reset


# ------------------------------------------------------------------ leg end


class Path(NamedTuple):
    """A path's throughput (``cr, cg, cb``) and gathered radiance."""

    cr: torch.Tensor
    cg: torch.Tensor
    cb: torch.Tensor
    lr: torch.Tensor
    lg: torch.Tensor
    lb: torch.Tensor


def _fresh_path(n, device):
    one = torch.ones(n, dtype=torch.float32, device=device)
    zero = torch.zeros(n, dtype=torch.float32, device=device)
    return Path(one, one, one, zero, zero, zero)


def ray_ids(pxi, pyi, width, height):
    """The id each path tracer keys its draws on: ``tile*128 + lane`` of
    the superblock-major [T,128] layout of a ``width`` x ``height`` frame
    (wavefront3.py:2943, pathtrace4.py:557), for pixels ``(pxi, pyi)``;
    int64."""
    nsx = _sb_dims(width // TILE_W, height // TILE_H)[0]
    txi, tyi = pxi // TILE_W, pyi // TILE_H
    tg = (((tyi // SB_H) * nsx + txi // SB_W) * _BLK
          + (tyi % SB_H) * SB_W + txi % SB_W)
    return (tg * 128 + (pyi % TILE_H) * TILE_W + pxi % TILE_W).long()


def _mul32(h, c):
    """``h * c`` mod 2^32 of int64 words below 2^32, without overflow."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def hash_u01(rid, base, j):
    """Draw ``j`` of each ray: the murmur3 finalizer of ``rid ^ base ^
    j*0x632BE5AB`` (uint32 arithmetic on int64 words), its top 23 bits
    mapped into (0, 1) (wavefront3.py:2945-2954, pathtrace4.py:559-571)."""
    h = rid ^ ((base ^ (j * 0x632BE5AB)) & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 9).to(torch.float32) * (1.0 / (1 << 23)) + (1.0 / (1 << 24))


def _sstep(e0, e1, x):
    q = torch.clamp((x - e0) * (1.0 / (e1 - e0)), 0.0, 1.0)
    return q * q * (3.0 - 2.0 * q)


def _sky_rgb(sf, ox, oy, oz, dx, dy, dz):
    """Sky radiance along each ray, with the sun disc seen from its origin
    (wavefront3.py:2455-2471): sun position ``sf[27:30]``, intensity
    ``sf[30]``, sky colour ``sf[31:34]``."""
    gts = _sstep(-0.01, 0.0, dy)
    grad_t = torch.pow(_sstep(0.0, 0.4, dy), 0.35)
    sv = [sf[27] - ox, sf[28] - oy, sf[29] - oz]
    sn = sqrt_rn(sv[0] * sv[0] + sv[1] * sv[1] + sv[2] * sv[2])
    sdot = (dx * sv[0] + dy * sv[1] + dz * sv[2]) / sn
    sun = ((sdot > 0.99) & (gts >= 1.0)).to(torch.float32) * sf[30]

    def chan(h, vd, sc):
        g = h + float(np.float32(sc) - np.float32(h)) * grad_t
        return vd + (g - vd) * gts + sun

    return (chan(1.0, 0.03, sf[31]), chan(0.3, 0.03, sf[32]),
            chan(0.0, 0.03, sf[33]))


def _leg_water(ts, wa, we, t_exit):
    """Water length of a finished leg: closed intervals plus the open one
    closed where the leg stopped (``min(ts, t_exit)``)."""
    return wa + torch.where(we >= 0.0, torch.minimum(ts, t_exit) - we, 0.0)


def _leg_shade(sf, path, rays, live, hit, water, mat):
    """The end of one leg for the rays in ``live`` (wavefront3.py:
    2895-2914, pathtrace4.py:590-605): Beer-Lambert absorption along the
    leg's water, sky radiance for rays that missed, emission and albedo
    of hit voxels. Returns the new path and the rays that hit."""
    kx, ky, kz = _WATER_ABSORB
    cr = torch.where(live, path.cr * torch.exp(-water * kx), path.cr)
    cg = torch.where(live, path.cg * torch.exp(-water * ky), path.cg)
    cb = torch.where(live, path.cb * torch.exp(-water * kz), path.cb)
    skr, skg, skb = _sky_rgb(sf, *rays)
    miss = live & ~hit
    lr = path.lr + torch.where(miss, cr * skr, 0.0)
    lg = path.lg + torch.where(miss, cg * skg, 0.0)
    lb = path.lb + torch.where(miss, cb * skb, 0.0)
    h = live & hit
    lr = lr + torch.where(h, cr * mat.emission * mat.r, 0.0)
    lg = lg + torch.where(h, cg * mat.emission * mat.g, 0.0)
    lb = lb + torch.where(h, cb * mat.emission * mat.b, 0.0)
    cr = torch.where(h, cr * mat.r, cr)
    cg = torch.where(h, cg * mat.g, cg)
    cb = torch.where(h, cb * mat.b, cb)
    return Path(cr, cg, cb, lr, lg, lb), h


def _bounce_rays(rays, ts, axm, scat, rid, base):
    """The next ray of every path (wavefront3.py:2919-3019,
    pathtrace4.py:609-679): a unit-sphere Box-Muller sample about the
    face normal (``-sign(d)`` on the exit axes of ``axm``, ``-d`` when
    there are none), mixed with the mirror reflection by the material's
    ``scat``; the origin is the hit point with its crossing coordinates
    snapped to their face (``floor(x + 0.5)``), nudged 4e-3 along the
    normal. ``base`` keys the draws (:func:`hash_u01`)."""
    f32 = torch.float32
    ox, oy, oz, dx, dy, dz = rays
    d = (dx, dy, dz)
    bits = [((axm >> i) & 1) != 0 for i in range(3)]
    n = [-torch.sign(c) * b.to(f32) for c, b in zip(d, bits)]
    degen = (n[0] == 0.0) & (n[1] == 0.0) & (n[2] == 0.0)
    n = [torch.where(degen, -c, nc) for c, nc in zip(d, n)]

    u1, u2, u3, u4 = (hash_u01(rid, base, j) for j in range(4))
    r1 = sqrt_rn(-2.0 * torch.log(u1))
    a1 = u2 * _TWO_PI
    r2 = sqrt_rn(-2.0 * torch.log(u3))
    a2 = u4 * _TWO_PI
    v = [r1 * torch.cos(a1), r1 * torch.sin(a1), r2 * torch.cos(a2)]
    rn = torch.clamp_min(sqrt_rn(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]),
                         1e-6)
    df = [nc + vc / rn for nc, vc in zip(n, v)]
    dn = sqrt_rn(df[0] * df[0] + df[1] * df[1] + df[2] * df[2])
    dnm = torch.clamp_min(dn, 1e-6)
    df = [torch.where(dn > 1e-6, c / dnm, nc) for c, nc in zip(df, n)]
    dot = dx * n[0] + dy * n[1] + dz * n[2]
    sp = [c - 2.0 * dot * nc for c, nc in zip(d, n)]
    keep = 1.0 - scat
    nd = [a * scat + b * keep for a, b in zip(df, sp)]
    nn = sqrt_rn(nd[0] * nd[0] + nd[1] * nd[1] + nd[2] * nd[2])
    nnm = torch.clamp_min(nn, 1e-6)
    nd = [torch.where(nn > 1e-6, c / nnm, nc) for c, nc in zip(nd, n)]

    p = [o + c * ts for o, c in zip((ox, oy, oz), d)]
    p = [torch.where(b, torch.floor(pc + 0.5), pc) for pc, b in zip(p, bits)]
    return (*(pc + nc * _EPS_N for pc, nc in zip(p, n)), *nd)


def _sample_base(kd):
    """The per-ray hash base of one key: ``kd[0] ^ kd[1]*0x9E3779B9``."""
    return int(kd[0]) ^ ((int(kd[1]) * _GOLDEN) & _M32)


# -------------------------------------------------------------------- frame


def pt_scal(rg, cam, *, world_min, sky_color, sun_pos, sun_intensity,
            step_cap, key):
    """Host f32[43] scalar row of a path-traced frame: :func:`_scal_row`
    (camera, world edge, step cap, tile counts), then the sun position
    (27-29, world-local), its intensity (30), the sky colour (31-33) and
    the key's four 16-bit seed quads (34-37), as ``_pt_frame4`` lays them
    out (pathtrace4.py:884-891)."""
    f32 = np.float32
    width, height = cam.proj_size
    wm = rg.world_min if world_min is None else world_min
    if isinstance(wm, torch.Tensor):
        wm = wm.cpu().numpy()
    wm = np.asarray(wm, f32)
    origin = np.asarray(cam.pos, f32) - wm
    scal = _scal_row(rg, origin, cam.inv_view, cam.inv_proj, width, height,
                     step_cap)
    scal[27:30] = np.asarray(sun_pos, f32).reshape(3) - wm
    scal[30] = sun_intensity
    scal[31:34] = np.asarray(sky_color, f32).reshape(3)
    kd = prng.key_data(key)
    scal[34:38] = [kd[0] & 0xFFFF, kd[0] >> 16, kd[-1] & 0xFFFF, kd[-1] >> 16]
    return scal


def pt_inputs(rg, cam, materials, *, world_min=None,
              sky_color=(0.81, 0.93, 1.0), sun_pos=(0.0, 10_000.0, 0.0),
              sun_intensity=4.0, step_cap=None, key=None, prepared=None):
    """``(scal, gw2, mlut, sw_cont, wmeta_pad)`` of a path-traced frame on
    the grid's device (the host row is ``scal.cpu()``), and its cropped
    ``(height, width)``. The path tracers march dense tables only, as in
    JAX: a :class:`~.wavefront4.PreparedGrid4Sparse` raises."""
    if isinstance(prepared, PreparedGrid4Sparse):
        raise ValueError("the path tracers march dense tables only; got "
                         "PreparedGrid4Sparse")
    device = rg.sw_solid.device
    scal = pt_scal(rg, cam, world_min=world_min, sky_color=sky_color,
                   sun_pos=sun_pos, sun_intensity=sun_intensity,
                   step_cap=step_cap, key=key)
    mlut = material_lut_rows(materials.color, materials.emission,
                             materials.scatter).to(device)
    gw2, sw_cont, wmeta_pad, _ = _tables(rg, prepared)
    return ((torch.from_numpy(scal).to(device), gw2, mlut, sw_cont,
             wmeta_pad), _frame_dims(*cam.proj_size))


def _flat(mat):
    return Materials(*(m.reshape(-1) for m in mat))


def _bundle(rays, live, height, width):
    o = torch.stack(rays[:3], dim=-1).reshape(height, width, 3)
    d = torch.stack(rays[3:], dim=-1).reshape(height, width, 3)
    return o, d, live.reshape(height, width)


def _path_frame(scal, gw2, mlut, sw_cont, wmeta_pad, *, height, width,
                full_size, bounces, samples, key, legs=None):
    """Radiance f32[height, width, 3] of a frame: the camera leg marched
    once, then per sample each bounce leg as a bundle, with the leg ends
    of :func:`_leg_shade` and :func:`_bounce_rays`
    (wavefront3.py:_path_frame). ``legs``: ``(primary(), bounce(origins,
    dirs, active))`` returning the raw planes ``(ts, fl, wa, we)`` [H,W]
    of a leg; None marches both on the v4 route (:func:`march_planes4`)."""
    sf = [float(x) for x in scal.cpu().numpy()]
    dims = dict(height=height, width=width)
    pxi, pyi = _pixels(height, width, sw_cont.device)
    rid = ray_ids(pxi, pyi, *full_size)
    cam_rays = _camera_rays(sf, pxi, pyi)
    if legs is None:
        legs = (lambda: march_planes4(scal, gw2, sw_cont, wmeta_pad, **dims),
                lambda o, d, a: march_planes4(scal, gw2, sw_cont, wmeta_pad,
                                              o, d, a, **dims))
    # the camera leg is the same for every sample
    prim = legs[0]()
    prim_mat = _flat(matfetch4(prim[1], mlut))
    acc = None
    for skey in prng.split(key, samples):
        rays, planes, mat = cam_rays, prim, prim_mat
        live = torch.ones(pxi.shape, dtype=torch.bool, device=pxi.device)
        path = _fresh_path(pxi.numel(), pxi.device)
        for bounce in range(bounces + 1):
            if bounce:
                planes = legs[1](*_bundle(rays, live, height, width))
                mat = _flat(matfetch4(planes[1], mlut))
            ts, fl, wa, we = (p.reshape(-1) for p in planes)
            t_exit = _slab_exit(sf[3], *rays[:3],
                                [_inv_dir(c) for c in rays[3:]])
            water = _leg_water(ts, wa, we, t_exit)
            hit = ((fl >> _FL_HIT) & 1) != 0
            path, live = _leg_shade(sf, path, rays, live, hit, water, mat)
            if bounce == bounces:
                break
            base = _sample_base(prng.fold_in(skey, bounce))
            rays = _bounce_rays(rays, ts, (fl >> _FL_AX) & 7, mat.scatter,
                                rid, base)
        rgb = torch.stack(path[3:], dim=-1)
        acc = rgb if acc is None else acc + rgb
    return (acc * (1.0 / samples)).reshape(height, width, 3)


def _v3_legs(rg, cam, scal, *, height, width, rounds, sub_rounds,
             step_cap):
    """The legs of the v3 route (wavefront3.py:2536-2542, :2857-2867):
    the camera leg through the v3 round loop at ``rounds``, each bounce
    bundle at ``max(rounds * 2 // 3, 4)``; raw planes in image order,
    contiguous (a cropped untile is a view, and :func:`matfetch4`'s
    kernel takes contiguous planes)."""
    from .wavefront3 import (
        _require_tiles,
        _tile_bundle,
        _trace_frame,
        _untile_hw,
    )

    w, h = cam.proj_size
    _require_tiles(w, h)
    kw = dict(width=w, height=h, sub_rounds=sub_rounds, step_cap=step_cap,
              raw_out=True)

    def image(planes):
        return tuple(_untile_hw(p, w // TILE_W, h // TILE_H, width,
                                height).contiguous() for p in planes)

    def primary():
        origin = scal[:3].cpu().numpy()
        return image(_trace_frame(rg, origin, cam.inv_view, cam.inv_proj,
                                  rounds=rounds, **kw))

    def bounce(o, d, a):
        rays, act = _tile_bundle(o, d, a, w, h, o.device)
        eye = np.eye(4, dtype=np.float32)
        return image(_trace_frame(rg, np.zeros(3, np.float32), eye, eye,
                                  rays, act, rounds=max(rounds * 2 // 3, 4),
                                  **kw))

    return primary, bounce


def path_trace3(rg, cam, materials, *, world_min=None,
                sky_color=(0.81, 0.93, 1.0), sun_pos=(0.0, 10_000.0, 0.0),
                sun_intensity=4.0, bounces=1, samples=1, key=None, rounds=16,
                steps_per_round=48, step_cap=None, v4=False, prepared=None,
                cache=None, return_cache=False, **schedule):
    """Path-traced frame -> f32[H,W,3] linear radiance (the sample mean),
    on the grid's device.

    The signature of the JAX ``path_trace3``. ``materials`` is a
    MaterialTable (colour, emission and scatter are read); ``key`` is raw
    key data ``uint32[2]`` (``np.asarray(jax.random.PRNGKey(k))``), None
    for ``PRNGKey(0)``. ``v4=False`` (JAX's default) marches every leg
    through the v3 round loop, as JAX does: the camera leg at ``rounds``
    service rounds, each bounce at ``max(rounds * 2 // 3, 4)``, each round
    ``steps_per_round // 8`` sub-rounds (``prim_steps_per_round``, where
    given, sets it for both legs, as in JAX); a ray still active when its
    rounds run out counts as a miss. ``v4=True`` marches every leg to its
    end on the v4 route, which equals JAX's v4 legs; ``rounds`` and
    ``steps_per_round`` then mean nothing, and the other
    :data:`SCHEDULE_KNOBS` are TPU schedule and are ignored on both
    routes. ``cache``/``return_cache``: the v4 route's warm token is
    inert, as in :func:`~.wavefront4.render_frame4`; the v3 route, as in
    JAX, returns None for it. ``return_cache=True`` returns ``(img,
    token)``.
    """
    unknown = set(schedule) - SCHEDULE_KNOBS
    if unknown:
        raise TypeError(f"path_trace3 got unexpected keywords {sorted(unknown)}")
    del cache  # inert token
    args, (h, w) = pt_inputs(rg, cam, materials, world_min=world_min,
                             sky_color=sky_color, sun_pos=sun_pos,
                             sun_intensity=sun_intensity, step_cap=step_cap,
                             prepared=prepared)
    legs = None
    if not v4:
        spr = schedule.get("prim_steps_per_round") or steps_per_round
        legs = _v3_legs(rg, cam, args[0], height=h, width=w,
                        rounds=int(rounds), sub_rounds=max(int(spr) // 8, 1),
                        step_cap=None if step_cap is None else int(step_cap))
    img = _path_frame(*args, height=h, width=w, full_size=cam.proj_size,
                      bounces=int(bounces), samples=int(samples), key=key,
                      legs=legs)
    if return_cache:
        return img, (_token(cam.proj_size, img.device) if v4 else None)
    return img


def path_trace4(rg, cam, materials, **kw):
    """Path-traced frame with every leg on the v4 march: the JAX
    ``path_trace4`` (wavefront4.py:2651), :func:`path_trace3` with
    ``v4=True``."""
    return path_trace3(rg, cam, materials, v4=True, **kw)
