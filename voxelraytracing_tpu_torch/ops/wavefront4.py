"""The v4 frame: march the bit-plane world, shade each pixel to packed
RGBA8, with or without hard shadows, in one launch or split.

Port of ``voxelraytracing_tpu/ops/wavefront4.py`` — the fused frame
(``render_frame4(fused=True)`` -> ``_frame_fused4``, one launch of
``_march_kernel4``, shadow leg included), the state-plane march
(``_trace_frame4``) and the split frame (``_shadow_prep4``,
``_shade_fin4``) — and of the split shade kernel
``voxelraytracing_tpu/ops/wavefront3.py:_shade``. The JAX kernel serves
subwindow rows to a per-block VMEM cache in rounds; that service is TPU
schedule and changes no pixel (tests/test_wavefront4.py pins it), so the
port keeps only the per-ray semantics: each ray marches on its own until
it hits, leaves the world or the slab, or reaches the step cap.

Four kernels, each a wrapper that launches the hand-written CUDA kernel
on CUDA tensors and runs the plain PyTorch version on CPU tensors:

  * :func:`march_fused4` (``csrc/march4.cu``): march + shadow leg + shade;
    plain version :func:`march_fused4_ref`.
  * :func:`touched4` (``csrc/planes4.cu``): mark the tiles that hold a
    ray active at start; plain :func:`touched4_ref`.
  * :func:`march_planes4` (``csrc/planes4.cu``): march camera rays or
    per-ray bundles to the raw state planes (after :func:`touched4`);
    plain :func:`march_planes4_ref`.
  * :func:`shade4` (``csrc/shade4.cu``): the split shade of those planes;
    plain :func:`shade4_ref`.

The march kernels take dense tables (:class:`PreparedGrid4`) or sparse
ones (:class:`PreparedGrid4Sparse`, the JAX kernel's ``sparse=True`` mode:
``sparse_ns`` > 0 selects their sparse instantiations).

Entry points with the JAX signatures: :func:`render_frame4`,
:func:`trace_wavefront4`, :func:`trace_wavefront4_rays`. Per-pixel planes
stay in image order ``[H, W]`` inside the port; the public functions
return the JAX package's image-order products.

Bit words are int32 tensors holding the JAX package's uint32 bits; every
right shift is masked, since ``>>`` sign-extends words with bit 31 set.
"""

import ctypes
import logging
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .camera import sqrt_rn
from .wavefront import BRICK, EPS_T, TILE_H, TILE_W, _BIG, _BIG_IV, WavefrontResult
from .wavefront3 import (
    SB_H,
    SB_W,
    SW,
    WIN,
    _BLK,
    _FL_AX,
    _FL_HIT,
    _FL_SGN,
    _FL_STP,
    _FL_VOX,
    _FL_ZERO,
    RenderGrid3,
    _cam_scal,
    _gs_for,
    _inv_dir,
    _pixel_dirs,
    _require_tiles,
    _sb_dims,
    _slab_exit,
    color_lut_rows,
)

_log = logging.getLogger(__name__)

N_SCAL = 43  # scalar row: _cam_scal's 27 + shade params (see frame_args)


def _spread16(v):
    """Spread the low 16 bits of each word to the even bit positions."""
    v = v & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    return (v | (v << 1)) & 0x55555555


def _interleave_gw(gw_jump, gw_liq):
    """(jump|liquid)-pair global plane: bit i of word w in each input
    becomes bits 2i/2i+1 of flat word 2w+(i>=16). Returned as [2,128]
    rows: window ``wg``'s pair sits in flat word ``wg>>4`` at shift
    ``(wg&15)*2``, for all 4096 windows of the plane."""
    lo = _spread16(gw_jump) | (_spread16(gw_liq) << 1)
    hi = _spread16(gw_jump >> 16) | (_spread16(gw_liq >> 16) << 1)
    flat = torch.stack([lo, hi], dim=-1).reshape(gw_jump.shape[0], 256)
    return flat.reshape(2, 128)


def _interleave_meta(m):
    """Meta words 0-1 (jump bits) + 2-3 (liquid bits) -> words 0-3
    with bit 2i = jump_i, 2i+1 = liq_i: one load yields both flags
    (words 4+ pass through)."""
    j, l = m[:, 0:2], m[:, 2:4]
    out = torch.stack(
        [
            _spread16(j[:, 0]) | (_spread16(l[:, 0]) << 1),
            _spread16(j[:, 0] >> 16) | (_spread16(l[:, 0] >> 16) << 1),
            _spread16(j[:, 1]) | (_spread16(l[:, 1]) << 1),
            _spread16(j[:, 1] >> 16) | (_spread16(l[:, 1] >> 16) << 1),
        ],
        dim=1,
    )
    return torch.cat([out, m[:, 4:]], dim=1)


class PreparedGrid4(NamedTuple):
    """Packed tables for the v4 march, computed once per world state by
    :func:`prepare_grid4` (int32 words)."""

    sw_cont: torch.Tensor    # [Ns³,7,128] solid|liquid|pid×4|meta
    wmeta_pad: torch.Tensor  # [Nw³,1,128] interleaved window metas


class PreparedGrid4Sparse(NamedTuple):
    """Sparse packed tables (JAX wavefront4.py:2185-2200): content rows
    only for the subwindows that need voxel bits (non-jump), all-solid
    ones shared as canonical rows. Lanes 64-127 of each window-meta row
    hold the content row of the window's 64 subwindows (local subwindow
    ``sx + sy*4 + sz*16``; -1 where there is none), so the march
    translates a subwindow to its row through the meta row it reads
    anyway; it reads a -1 as an empty subwindow (see
    :func:`_content_base`). A content row carries its subwindow id at
    meta lane 8. Maintained by
    :meth:`~..world.render_grid.RenderGrid3Builder.prepared_sparse`; the
    dense table of the reference's 80-chunk window would be ~15 GB."""

    sw_cont: torch.Tensor    # [R,7,128] content rows
    wmeta_pad: torch.Tensor  # [Nw³,1,128] metas + row indices at 64-127
    ns: int                  # subwindows per axis (R does not give it)


def _pack_tables4(wmeta, sw_meta, sw_solid, sw_liq, sw_pid):
    def pad128(m):
        return torch.nn.functional.pad(m, (0, 128 - m.shape[1]))

    sw_cont = torch.cat(
        [
            sw_solid[:, None, :],
            sw_liq[:, None, :],
            sw_pid,
            pad128(_interleave_meta(sw_meta))[:, None, :],
        ],
        dim=1,
    )
    wmeta_pad = pad128(_interleave_meta(wmeta))[:, None, :]
    return sw_cont.contiguous(), wmeta_pad.contiguous()


def prepare_grid4(rg: RenderGrid3) -> PreparedGrid4:
    """Pack a RenderGrid3's planes into the v4 table layout, on the grid's
    device. A pure function of the grid: recompute it whenever the grid
    changes (:class:`~..models.raytracer.WavefrontRenderer` keys it on
    grid identity)."""
    return PreparedGrid4(*_pack_tables4(
        rg.wmeta, rg.sw_meta, rg.sw_solid, rg.sw_liq, rg.sw_pid
    ))


def _cube_root(n):
    r = int(round(n ** (1 / 3)))
    while r * r * r < n:
        r += 1
    if r * r * r != n:
        raise ValueError(f"{n} table rows is not a cube")
    return r


def _world_dims(sw_cont, wmeta_pad, sparse_ns=0):
    """(nw, ns, gs) of a table pair: dense tables give ``ns`` by their
    row count, sparse ones (``sparse_ns`` > 0) by ``sparse_ns``."""
    ns = int(sparse_ns) if sparse_ns else _cube_root(sw_cont.shape[0])
    nw = _cube_root(wmeta_pad.shape[0])
    if ns != 4 * nw:
        raise ValueError(f"{ns} subwindows per axis for {nw} windows")
    return nw, ns, _gs_for(nw)


def _sparse_ns(prepared):
    """``ns`` of a sparse token, 0 for dense tables."""
    return int(prepared.ns) if isinstance(prepared, PreparedGrid4Sparse) else 0


# ------------------------------------------------------------- plain version


class _World(NamedTuple):
    """The march's view of one frame: world edge, step cap, table dims, the
    flat tables and whether they are sparse."""

    v: float
    step_cap: int
    nw: int
    ns: int
    gs: int
    gw: torch.Tensor
    wm: torch.Tensor
    swc: torch.Tensor
    sparse: bool = False


def _world_of(scal, gw2, sw_cont, wmeta_pad, sparse_ns=0):
    """(world, scalar row as Python floats holding f32 values)."""
    s = scal.detach().cpu().numpy().astype(np.float32)
    sf = [float(x) for x in s]
    nw, ns, gs = _world_dims(sw_cont, wmeta_pad, sparse_ns)
    return _World(sf[3], _step_cap(sf), nw, ns, gs, gw2.reshape(-1),
                  wmeta_pad.reshape(-1), sw_cont.reshape(-1),
                  bool(sparse_ns)), sf


def _content_base(wd, vx, vy, vz):
    """``(base, missing)``: the flat word offset of the content row of the
    subwindow holding voxel ``(vx, vy, vz)``, and where a sparse table has
    no row for it. Dense tables index the row by subwindow id; sparse
    tables read it from lane ``64 + s_loc`` of the window's meta row,
    where -1 means no row (``base`` then points at row 0, never read);
    ``missing`` is None for dense tables.
    The march reads a missing row as an empty subwindow: that is what a
    jump subwindow holds, and what every subwindow of a window no chunk
    was ever installed in holds (the builder leaves that window's meta
    lanes at 0, so its subwindows do not read as jumps)."""
    if not wd.sparse:
        sid = (vx >> 4) + (vy >> 4) * wd.ns + (vz >> 4) * (wd.ns * wd.ns)
        return sid.long() * (7 * 128), None
    nw = wd.nw
    w = (vx >> 6) + (vy >> 6) * nw + (vz >> 6) * (nw * nw)
    s_loc = ((vx >> 4) & 3) + ((vy >> 4) & 3) * 4 + ((vz >> 4) & 3) * 16
    ridx = wd.wm[w.long() * 128 + 64 + s_loc.long()]
    return ridx.clamp_min(0).long() * (7 * 128), ridx < 0


def _step_cap(sf):
    """The step cap of a scalar row (``scal[23]``; none when it is 0)."""
    return int(sf[23]) if sf[23] > 0.5 else 1_000_000_000


def _pixels(height, width, device):
    """Flat int32 (px, py) of every pixel of a [height, width] frame."""
    i32 = torch.int32
    pyi, pxi = torch.meshgrid(
        torch.arange(height, dtype=i32, device=device),
        torch.arange(width, dtype=i32, device=device), indexing="ij")
    return pxi.reshape(-1), pyi.reshape(-1)


def _camera_rays(sf, pxi, pyi):
    """Origins (the camera, per ray) and unit directions of pixels."""
    f32 = torch.float32
    dx, dy, dz = _pixel_dirs(sf, pxi.to(f32), pyi.to(f32) + sf[21])
    return (*(torch.full_like(dx, sf[i]) for i in range(3)), dx, dy, dz)


def _sb_grid(height, width):
    """Superblocks (128x64 pixels, one JAX block of 64 tiles) across and
    down a [height, width] frame that :func:`_frame_dims` cropped."""
    return -(-width // (SB_W * TILE_W)), -(-height // (SB_H * TILE_H))


def _tile_ok(sf, pxi, pyi):
    """A whole 16x8 tile inside the frame (scal[25-26] = tile counts)."""
    f32 = torch.float32
    return ((pxi // TILE_W).to(f32) < sf[25]) & ((pyi // TILE_H).to(f32) < sf[26])


def _strictly_inside(v, ox, oy, oz):
    return (ox > 0.0) & (ox < v) & (oy > 0.0) & (oy < v) & (oz > 0.0) & (oz < v)


def _ray_consts(v, ox, oy, oz, dx, dy, dz):
    """Per-ray DDA constants (wavefront4.py _make_leg): direction signs as
    ±1, signed inverse directions, axis-parallel guards, slab exit."""
    f32 = torch.float32
    iv = [_inv_dir(dx), _inv_dir(dy), _inv_dir(dz)]
    sgf = [(d > 0.0).to(f32) for d in (dx, dy, dz)]
    sgf = [sc + sc - 1.0 for sc in sgf]                     # ±1 exactly
    ivs = [i * g for i, g in zip(iv, sgf)]
    big = [i.abs() >= 0.99 * _BIG_IV for i in iv]
    return sgf, ivs, big, _slab_exit(v, ox, oy, oz, iv)


def _leg_starts(v, step_cap, ox, oy, oz, dx, dy, dz, t_exit):
    """Whether a ray that is active at start takes its first step: at
    ``t = EPS_T`` it lies inside the world and before its slab exit."""
    p = [o + d * EPS_T for o, d in ((ox, dx), (oy, dy), (oz, dz))]
    inw = (p[0] >= 0.0) & (p[1] >= 0.0) & (p[2] >= 0.0) \
        & (p[0] < v) & (p[1] < v) & (p[2] < v)
    return inw & (EPS_T < t_exit) & bool(0 < step_cap)


def _leg_ref(wd, ox, oy, oz, dx, dy, dz, active):
    """One march leg of flat per-ray tensors from ``t = EPS_T``.

    Per ray, in the JAX kernel's op order (wavefront4.py:_march_kernel4):
    steps classified from position alone — global window (super-cell)
    jump, subwindow jump from the window meta, brick skip from the
    subwindow meta, else a voxel bit test (the subwindow's content row
    found as :func:`_content_base` says; a missing sparse row marches as
    an empty subwindow jump) — each advancing by the DDA exit
    of its cell plus EPS_T, with the water interval tracked, until hit,
    exit or ``stp >= step_cap``. Every multiply and add rounds on its own,
    as in the CUDA kernels. Returns ``(t_exit, t, hit, axm, water, wenter,
    stp)``: ``t`` clamped to ``t_exit``, ``water`` the closed liquid
    intervals, ``wenter`` the start of an open one or -1."""
    dev = dx.device
    f32, i32 = torch.float32, torch.int32
    v, step_cap, nw, gs = wd.v, wd.step_cap, wd.nw, wd.gs
    nwg = (nw + (1 << gs) - 1) >> gs
    sgf, ivs, big, t_exit = _ray_consts(v, ox, oy, oz, dx, dy, dz)
    n = dx.numel()
    t = torch.full((n,), EPS_T, dtype=f32, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    axm = torch.zeros(n, dtype=i32, device=dev)
    water = torch.zeros(n, dtype=f32, device=dev)
    wenter = torch.full((n,), -1.0, dtype=f32, device=dev)
    stp = torch.zeros(n, dtype=i32, device=dev)

    # The live set: ray indices plus their per-ray constants and state,
    # compacted every step so finished rays cost nothing.
    idx = torch.nonzero(active).squeeze(1)
    const = [c[idx] for c in (ox, oy, oz, dx, dy, dz, *sgf, *ivs, *big, t_exit)]
    st = [x[idx] for x in (t, hit, axm, water, wenter, stp)]
    while idx.numel():
        # a ray stops once it hit, left the slab or the world, or used up
        # its steps; stopped rays write their state back and leave the set
        pos = [o + d * st[0] for o, d in zip(const[0:3], const[3:6])]
        alive = ~st[1] & (st[0] < const[15]) & (st[5] < step_cap)
        for pc in pos:
            alive = alive & (pc >= 0.0) & (pc < v)
        if not bool(alive.all()):
            done = torch.nonzero(~alive).squeeze(1)
            for full, part in zip((t, hit, axm, water, wenter, stp), st):
                full[idx[done]] = part[done]
            keep = torch.nonzero(alive).squeeze(1)
            idx = idx[keep]
            if not idx.numel():
                break
            const = [c[keep] for c in const]
            st = [x[keep] for x in st]
            pos = [pc[keep] for pc in pos]
        gfx, gfy, gfz, isx, isy, isz, bgx, bgy, bgz = const[6:15]
        ct, _, caxm, cwat, cwen, cstp = st
        px, py, pz = pos

        vx = torch.floor(px).to(i32)
        vy = torch.floor(py).to(i32)
        vz = torch.floor(pz).to(i32)
        w = (vx >> 6) + (vy >> 6) * nw + (vz >> 6) * (nw * nw)
        if gs:
            wg = ((vx >> (6 + gs)) + (vy >> (6 + gs)) * nwg
                  + (vz >> (6 + gs)) * (nwg * nwg))
        else:
            wg = w
        g_pair = (wd.gw[(wg >> 4).long()] >> ((wg & 15) * 2)) & 3
        s_loc = ((vx >> 4) & 3) + ((vy >> 4) & 3) * 4 + ((vz >> 4) & 3) * 16
        w_word = wd.wm[(w.long() * 128 + (s_loc >> 4).long())]
        sw_pair = (w_word >> ((s_loc & 15) * 2)) & 3
        base, missing = _content_base(wd, vx, vy, vz)
        case1 = (g_pair & 1) != 0
        sw_jump = (sw_pair & 1) != 0
        case2 = ~case1 & (sw_jump if missing is None else sw_jump | missing)
        case3 = ~case1 & ~case2
        b_loc = ((vx >> 2) & 3) + ((vy >> 2) & 3) * 4 + ((vz >> 2) & 3) * 16
        b_word = wd.swc[base + 6 * 128 + (b_loc >> 4).long()]
        br_pair = (b_word >> ((b_loc & 15) * 2)) & 3
        l = (vx & 15) + (vy & 15) * 16 + (vz & 15) * 256
        lw = base + (l >> 5).long()
        vsolid = ((wd.swc[lw] >> (l & 31)) & 1) != 0
        vliq = ((wd.swc[lw + 128] >> (l & 31)) & 1) != 0

        in_br = case3 & ((br_pair & 1) != 0)
        in_vox = case3 & ~in_br
        hit_now = in_vox & vsolid
        march = ~hit_now
        liquid = torch.where(
            case1, (g_pair & 2) != 0,
            torch.where(case2, (sw_pair & 2) != 0,
                        torch.where(in_br, (br_pair & 2) != 0, vliq)))

        # water interval: every live ray marches or hits this step
        leave = (cwen >= 0.0) & ~liquid
        cwat = cwat + torch.where(leave, ct - cwen, 0.0)
        cwen = torch.where(leave, -1.0, cwen)
        cwen = torch.where(march & liquid & (cwen < 0.0), ct, cwen)

        cell = torch.where(
            case1, float(WIN << gs),
            torch.where(case2, float(SW),
                        torch.where(in_br, float(BRICK), 1.0)))
        icell = 1.0 / cell

        def axis(pc, gf, ivsc, bigm):
            ps = pc * gf
            b = torch.floor(ps * icell) + 1.0
            return torch.where(bigm, _BIG, (b * cell - ps) * ivsc)

        dtx = axis(px, gfx, isx, bgx)
        dty = axis(py, gfy, isy, bgy)
        dtz = axis(pz, gfz, isz, bgz)
        dt = torch.minimum(dtx, torch.minimum(dty, dtz))
        axm_now = ((dtx <= dt).to(i32) | ((dty <= dt).to(i32) << 1)
                   | ((dtz <= dt).to(i32) << 2))
        ct = torch.where(march, ct + dt + EPS_T, ct)
        caxm = torch.where(march, axm_now, caxm)
        st = [ct, hit_now, caxm, cwat, cwen, cstp + 1]

    return t_exit, torch.minimum(t, t_exit), hit, axm, water, wenter, stp


def _decode_vox_ref(wd, ox, oy, oz, dx, dy, dz, t, hit):
    """Hit ids at ``t``: 4 palette-index bits + the subwindow palette
    byte (0 where no hit), read from the hit subwindow's content row."""
    i32 = torch.int32
    vox = torch.zeros(t.shape, dtype=i32, device=t.device)
    hi = torch.nonzero(hit).squeeze(1)
    if hi.numel():
        th = t[hi]
        vx = torch.floor(ox[hi] + dx[hi] * th).to(i32)
        vy = torch.floor(oy[hi] + dy[hi] * th).to(i32)
        vz = torch.floor(oz[hi] + dz[hi] * th).to(i32)
        base, missing = _content_base(wd, vx, vy, vz)
        l = (vx & 15) + (vy & 15) * 16 + (vz & 15) * 256
        lw = base + (l >> 5).long()
        pidx = torch.zeros_like(l)
        for b in range(4):
            pidx = pidx | (((wd.swc[lw + (2 + b) * 128] >> (l & 31)) & 1) << b)
        pal_w = wd.swc[base + 6 * 128 + 4 + (pidx >> 2).long()]
        ids = (pal_w >> ((pidx & 3) * 8)) & 0xFF
        vox[hi] = ids if missing is None else torch.where(missing, 0, ids)
    return vox


def _encode_flags(hit, axm, stp, vox, dx, dy, dz):
    """Flags word (wavefront3._FL_*) of a finished leg; bit 0 (still
    active) is 0."""
    i32 = torch.int32
    sgn = ((dx > 0.0).to(i32) | ((dy > 0.0).to(i32) << 1)
           | ((dz > 0.0).to(i32) << 2))
    return ((hit.to(i32) << _FL_HIT) | (axm << _FL_AX)
            | (torch.clamp_max(stp, 0xFFF) << _FL_STP) | (vox << _FL_VOX)
            | (sgn << _FL_SGN))


class MarchState(NamedTuple):
    """Per-ray products of the plain camera march, flat over
    ``height*width`` pixels: direction, final ``t`` (clamped to the slab
    exit ``t_exit``), hit, exit-axis mask, hit id, water length (interval
    closed at ``t``), open-interval start ``wenter`` and step count."""

    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    t: torch.Tensor
    t_exit: torch.Tensor
    hit: torch.Tensor
    axm: torch.Tensor
    vox: torch.Tensor
    water: torch.Tensor
    wenter: torch.Tensor
    stp: torch.Tensor


def march_ref(scal, gw2, sw_cont, wmeta_pad, *, height, width, sparse_ns=0):
    """The primary march of :func:`march_fused4_ref`, without the shade:
    camera rays of a whole tile inside the frame, from a camera strictly
    inside the world, through :func:`_leg_ref`; hit ids decoded, the
    water interval closed at ``t``."""
    wd, sf = _world_of(scal, gw2, sw_cont, wmeta_pad, sparse_ns)
    pxi, pyi = _pixels(height, width, sw_cont.device)
    rays = _camera_rays(sf, pxi, pyi)
    active = (_tile_ok(sf, pxi, pyi) & _strictly_inside(wd.v, *rays[:3])
              & bool(0 < wd.step_cap))
    t_exit, t, hit, axm, water, wenter, stp = _leg_ref(wd, *rays, active)
    vox = _decode_vox_ref(wd, *rays, t, hit)
    water = water + torch.where(wenter >= 0.0, t - wenter, 0.0)
    return MarchState(*rays[3:], t, t_exit, hit, axm, vox, water, wenter, stp)


def _shadow_rays(sf, dx, dy, dz, t, axm):
    """Shadow rays of primary hits, in the op order of the JAX kernel's
    fused leg and of ``_shadow_prep4`` (wavefront4.py:1288-1300,
    :2368-2381): the hit point ``o + d*t``, nudged 1e-3 along the face
    normal ``-sign(d) * axis bit``, aimed at the sun position
    (``scal[34:37]``). Returns origins and unit directions."""
    f32 = torch.float32
    h = [sf[i] + d * t + (-torch.sign(d) * ((axm >> i) & 1).to(f32)) * 1e-3
         for i, d in enumerate((dx, dy, dz))]
    sv = [sf[34 + i] - h[i] for i in range(3)]
    sn = sqrt_rn(sv[0] * sv[0] + sv[1] * sv[1] + sv[2] * sv[2])
    return (*h, *(c / sn for c in sv))


def _shade_pixels(sf, lut_flat, dx, dy, dz, hit, axm, vox, water, stp,
                  show_steps, max_steps, shm=None):
    """Shade epilogue in the JAX kernels' op order (shade_store,
    wavefront4.py:909-993; _shade_kernel, wavefront3.py:1909-2028) ->
    packed RGBA8 words. ``shm``: the shadow factor (the ambient where a
    hit is shadowed, else 1), applied after the step heatmap and before
    the sky."""
    f32, i32 = torch.float32, torch.int32
    cr, cg, cb = (lut_flat[ch * 256 + vox.long()] for ch in range(3))
    tint = torch.where((axm & 1) != 0, 0.5, 1.0).to(f32)
    tint = tint * torch.where((axm & 4) != 0, 0.7, 1.0)
    bottom = ((axm & 2) != 0) & (dy > 0.0)
    tint = tint * torch.where(bottom, 0.2, 1.0)
    cr, cg, cb = cr * tint, cg * tint, cb * tint
    if show_steps:
        max_t = torch.tensor(float(np.float32(max_steps)), dtype=f32,
                             device=stp.device)
        fstep = torch.clamp(stp.to(f32) / max_t, 0.0, 1.0)
        cr = cg = cb = fstep
    if shm is not None:
        cr, cg, cb = cr * shm, cg * shm, cb * shm

    def sstep(e0, e1, x):
        q = torch.clamp((x - e0) * (1.0 / (e1 - e0)), 0.0, 1.0)
        return q * q * (3.0 - 2.0 * q)

    gts = sstep(-0.01, 0.0, dy)
    grad_t = torch.pow(sstep(0.0, 0.4, dy), 0.35)
    sun_dot = dx * sf[27] + dy * sf[28] + dz * sf[29]
    sun = ((sun_dot > (1.0 - 0.01)) & (gts >= 1.0)).to(f32) * sf[30]

    def sky_chan(h, vd, sc):
        g = h + float(np.float32(sc) - np.float32(h)) * grad_t
        return vd + (g - vd) * gts + sun

    sr = sky_chan(1.0, 0.03, sf[31])
    sg = sky_chan(0.3, 0.03, sf[32])
    sb = sky_chan(0.0, 0.03, sf[33])
    r = torch.where(hit, cr, sr)
    g = torch.where(hit, cg, sg)
    b = torch.where(hit, cb, sb)
    factor = torch.clamp(water * (1.0 / 14.0), 0.8, 1.0)
    wet = water != 0.0
    keep = 1.0 - factor
    r = torch.where(wet, r * keep + 0.2 * factor, r)
    g = torch.where(wet, g * keep + 0.5 * factor, g)
    b = torch.where(wet, b * keep + 1.0 * factor, b)

    def q8(c):
        # a NaN channel (a NaN direction's sky) is byte 0, as XLA converts
        # NaN to an integer; torch's CPU cast alone gives INT_MIN
        return torch.nan_to_num(torch.clamp(c, 0.0, 1.0) * 255.0,
                                nan=0.0).to(i32)

    return q8(r) | (q8(g) << 8) | (q8(b) << 16) | -0x1000000


def march_fused4_ref(scal, gw2, lut, sw_cont, wmeta_pad, *, height, width,
                     show_steps=False, max_steps=1, shadows=False,
                     sparse_ns=0):
    """Plain PyTorch version of the fused v4 frame: march, shadow leg,
    shade.

    ``scal`` f32[43] (see :func:`frame_args`), ``gw2`` i32[2,128] pair
    plane, ``lut`` f32[6,128], ``sw_cont`` i32[Ns³,7,128], ``wmeta_pad``
    i32[Nw³,1,128], all on one device; with ``sparse_ns`` > 0 the tables
    are a :class:`PreparedGrid4Sparse` pair of that many subwindows per
    axis (``sw_cont`` i32[R,7,128]). With ``shadows``, each hit ray
    re-marches toward the sun position (``scal[34:37]``) from its
    normal-nudged hit point, under the same step cap; a shadowed hit keeps
    ``scal[37]`` of its light. Returns ``(packed, flags)``, both
    i32[height, width]: packed RGBA8 and the flags word of each pixel.
    """
    m = march_ref(scal, gw2, sw_cont, wmeta_pad, height=height, width=width,
                  sparse_ns=sparse_ns)
    wd, sf = _world_of(scal, gw2, sw_cont, wmeta_pad, sparse_ns)
    shm = None
    if shadows:
        srays = _shadow_rays(sf, m.dx, m.dy, m.dz, m.t, m.axm)
        start = m.hit & _strictly_inside(wd.v, *srays[:3])
        sh_hit = _leg_ref(wd, *srays, start)[2]
        shm = torch.where(sh_hit & m.hit, sf[37], 1.0)
    packed = _shade_pixels(sf, lut.reshape(-1), m.dx, m.dy, m.dz, m.hit,
                           m.axm, m.vox, m.water, m.stp, show_steps,
                           max_steps, shm)
    flags = _encode_flags(m.hit, m.axm, m.stp, m.vox, m.dx, m.dy, m.dz)
    return packed.reshape(height, width), flags.reshape(height, width)


def _start_rays(sf, pxi, pyi, origins, dirs, active):
    """The rays of a state-plane march and which are active at start.

    Camera rays when ``origins`` is None (active: a whole tile inside the
    frame and the camera strictly inside the world); else per-ray bundles
    ``origins``/``dirs`` f32[H,W,3] and ``active`` bool[H,W] (active: the
    flag, a valid tile and the origin strictly inside the world), as
    ``_trace_frame4`` inits them (wavefront4.py:1692-1703)."""
    valid = _tile_ok(sf, pxi, pyi)
    if origins is None:
        rays = _camera_rays(sf, pxi, pyi)
        fl0 = valid
    else:
        o, d = origins.reshape(-1, 3), dirs.reshape(-1, 3)
        rays = (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])
        fl0 = active.reshape(-1) & valid
    return rays, fl0 & _strictly_inside(sf[3], *rays[:3])


def _tile_marks(act0, height, width):
    """u8[ceil(H/8), ceil(W/16)]: 1 where a ray of the 16x8 tile takes a
    first step."""
    ty, tx = -(-height // TILE_H), -(-width // TILE_W)
    a = act0.reshape(height, width).to(torch.uint8)
    a = torch.nn.functional.pad(a, (0, tx * TILE_W - width,
                                    0, ty * TILE_H - height))
    return a.reshape(ty, TILE_H, tx, TILE_W).amax(dim=(1, 3))


def start_flags(scal, origins=None, dirs=None, active=None, *, height,
                width):
    """bool[height * width]: whether each ray of a state-plane march takes
    a first step (rays as in :func:`march_planes4_ref`)."""
    sf = [float(x) for x in scal.detach().cpu().numpy().astype(np.float32)]
    dev = scal.device if origins is None else origins.device
    rays, fl0 = _start_rays(sf, *_pixels(height, width, dev), origins, dirs,
                            active)
    t_exit = _ray_consts(sf[3], *rays)[3]
    return fl0 & _leg_starts(sf[3], _step_cap(sf), *rays, t_exit)


def touched4_ref(scal, origins=None, dirs=None, active=None, *, height,
                 width):
    """Plain PyTorch version of the start marks of a state-plane march:
    u8[ceil(height/8), ceil(width/16)], 1 for each 16x8 tile holding a ray
    that takes a first step (JAX: the per-block ``any_active`` of
    ``_march_kernel4``, wavefront4.py:883-892). Rays as in
    :func:`march_planes4_ref`."""
    return _tile_marks(start_flags(scal, origins, dirs, active,
                                   height=height, width=width),
                       height, width)


def march_planes4_ref(scal, gw2, sw_cont, wmeta_pad, origins=None,
                      dirs=None, active=None, *, height, width, sparse_ns=0):
    """Plain PyTorch version of the state-plane march.

    Camera rays when ``origins`` is None; else per-ray bundles
    ``origins``/``dirs`` f32[height,width,3] and ``active``
    bool[height,width] (see :func:`_start_rays` for which rays start).
    Tables as in :func:`march_fused4_ref`, sparse when ``sparse_ns`` > 0.
    Returns the raw planes ``(ts, fl, wa, we)``, each [height, width]:
    ``t`` clamped to the slab exit, the flags word, the water length of
    closed intervals, the open interval's start (or -1).

    As the JAX kernel does per 64-tile block, a 128x64-pixel superblock
    none of whose tiles :func:`touched4_ref` marks passes its start state
    through: zero planes for camera rays (flags ``_FL_ZERO``), ``(EPS_T,
    active bit, 0, -1)`` for bundles.
    """
    wd, sf = _world_of(scal, gw2, sw_cont, wmeta_pad, sparse_ns)
    pxi, pyi = _pixels(height, width, sw_cont.device)
    rays, fl0 = _start_rays(sf, pxi, pyi, origins, dirs, active)
    t_exit, t, hit, axm, wa, we, stp = _leg_ref(wd, *rays, fl0)
    vox = _decode_vox_ref(wd, *rays, t, hit)
    fl = _encode_flags(hit, axm, stp, vox, *rays[3:])

    # superblocks (JAX blocks) with a marked tile
    marks = _tile_marks(fl0 & _leg_starts(wd.v, wd.step_cap, *rays, t_exit),
                        height, width)
    nsx, nsy = _sb_grid(height, width)
    marks = torch.nn.functional.pad(marks, (0, nsx * SB_W - marks.shape[1],
                                            0, nsy * SB_H - marks.shape[0]))
    sb_on = marks.reshape(nsy, SB_H, nsx, SB_W).amax(dim=(1, 3)) != 0
    on = sb_on[(pyi // (SB_H * TILE_H)).long(),
               (pxi // (SB_W * TILE_W)).long()]
    if origins is None:
        planes = (torch.where(on, t, 0.0), torch.where(on, fl, _FL_ZERO),
                  torch.where(on, wa, 0.0), torch.where(on, we, 0.0))
    else:
        planes = (torch.where(on, t, EPS_T),
                  torch.where(on, fl, fl0.to(fl.dtype)),
                  torch.where(on, wa, 0.0), torch.where(on, we, -1.0))
    return tuple(p.reshape(height, width) for p in planes)


def shade4_ref(scal, lut, ts, fl, wa, we, sh, *, show_steps=False,
               shadows=False, max_steps=1):
    """Plain PyTorch version of the split shade (wavefront3._shade_kernel).

    ``scal`` is the split shade row f32[43] (``_cam_scal``'s 27, sun
    direction 27-29, intensity 30, sky 31-33, shadow ambient 34); the
    planes ``ts``/``wa``/``we`` f32 and ``fl``/``sh`` i32 are [H, W] in
    image order. Each pixel's camera direction and slab exit come from the
    scalar row; the water interval closes at ``min(ts, t_exit)``; with
    ``shadows``, a hit whose ``sh`` is non-zero keeps the ambient of its
    light. Returns packed RGBA8 i32[H, W]."""
    height, width = ts.shape
    sf = [float(x) for x in scal.detach().cpu().numpy().astype(np.float32)]
    pxi, pyi = _pixels(height, width, ts.device)
    rays = _camera_rays(sf, pxi, pyi)
    t_exit = _ray_consts(sf[3], *rays)[3]
    f = fl.reshape(-1)
    hit = ((f >> _FL_HIT) & 1) != 0
    we = we.reshape(-1)
    t_stop = torch.minimum(ts.reshape(-1), t_exit)
    water = wa.reshape(-1) + torch.where(we >= 0.0, t_stop - we, 0.0)
    shm = None
    if shadows:
        shm = torch.where((sh.reshape(-1) != 0) & hit, sf[34], 1.0)
    packed = _shade_pixels(sf, lut.reshape(-1), *rays[3:], hit,
                           (f >> _FL_AX) & 7, (f >> _FL_VOX) & 0xFF, water,
                           (f >> _FL_STP) & 0xFFF, show_steps, max_steps, shm)
    return packed.reshape(height, width)


# ------------------------------------------------------------------ kernels


def _check(dev, args):
    """Raise unless every ``(name, tensor, dtype, shape)`` is a contiguous
    tensor of that dtype and shape on ``dev``."""
    for name, x, dtype, shape in args:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dtype}{list(shape)} on {dev}, got "
                f"{x.dtype}{list(x.shape)} on {x.device}")


def _device_of(x, name):
    """The device a wrapper runs on: ``cpu`` takes the plain version,
    ``cuda`` the kernel; anything else raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return x.device


def _table_args(scal, gw2, sw_cont, wmeta_pad, sparse_ns=0):
    """Checks of the table arguments: ``sw_cont`` holds Ns³ rows, or any
    number of content rows when the tables are sparse."""
    nw, ns, _ = _world_dims(sw_cont, wmeta_pad, sparse_ns)
    rows = sw_cont.shape[0] if sparse_ns else ns ** 3
    return [("scal", scal, torch.float32, (N_SCAL,)),
            ("gw2", gw2, torch.int32, (2, 128)),
            ("sw_cont", sw_cont, torch.int32, (rows, 7, 128)),
            ("wmeta_pad", wmeta_pad, torch.int32, (nw ** 3, 1, 128))]


def _run(dev, name, launch, *args):
    """Call a kernel's C entry point on the current stream of ``dev``;
    raise on a CUDA error."""
    with torch.cuda.device(dev):
        rc = launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def march_fused4(scal, gw2, lut, sw_cont, wmeta_pad, *, height, width,
                 show_steps=False, max_steps=1, shadows=False, sparse_ns=0):
    """Fused v4 frame -> ``(packed, flags)`` i32[height, width].

    On CUDA tensors: one launch of the hand-written kernel
    ``csrc/march4.cu`` (built at first use), its sparse instantiation
    when ``sparse_ns`` > 0; on CPU tensors: the plain version
    :func:`march_fused4_ref`. Any other device raises. Same arguments as
    :func:`march_fused4_ref`."""
    dev = _device_of(sw_cont, "march_fused4")
    if dev.type == "cpu":
        return march_fused4_ref(scal, gw2, lut, sw_cont, wmeta_pad,
                                height=height, width=width,
                                show_steps=show_steps, max_steps=max_steps,
                                shadows=shadows, sparse_ns=sparse_ns)
    nw, ns, gs = _world_dims(sw_cont, wmeta_pad, sparse_ns)
    _check(dev, _table_args(scal, gw2, sw_cont, wmeta_pad, sparse_ns)
           + [("lut", lut, torch.float32, (6, 128))])
    packed = torch.empty((height, width), dtype=torch.int32, device=dev)
    flags = torch.empty((height, width), dtype=torch.int32, device=dev)
    _run(dev, "march_fused4", _build.load("march4").march_fused4_launch,
         scal.data_ptr(), gw2.data_ptr(), lut.data_ptr(), sw_cont.data_ptr(),
         wmeta_pad.data_ptr(), packed.data_ptr(), flags.data_ptr(),
         height, width, nw, ns, gs, int(bool(show_steps)),
         ctypes.c_float(float(np.float32(max_steps))), int(bool(shadows)),
         int(bool(sparse_ns)))
    march_fused4.launches += 1
    return packed, flags


march_fused4.launches = 0  # kernel launches since the last reset


def _bundle_checks(origins, dirs, active, height, width):
    if origins is None:
        return []
    return [("origins", origins, torch.float32, (height, width, 3)),
            ("dirs", dirs, torch.float32, (height, width, 3)),
            ("active", active, torch.bool, (height, width))]


def _bundle_ptrs(origins, dirs, active):
    return [None if x is None else x.data_ptr()
            for x in (origins, dirs, active)]


def touched4(scal, origins=None, dirs=None, active=None, *, height, width):
    """Start marks of a state-plane march -> u8[ceil(height/8),
    ceil(width/16)].

    On CUDA tensors: one launch in ``csrc/planes4.cu``,
    ``touched4_camera_kernel`` for camera rays (a representative ray a
    tile first, then the tiles left open a warp each),
    ``touched4_rays_kernel`` for bundles; on CPU tensors: the plain
    version :func:`touched4_ref`. Any other device raises. Same arguments
    as :func:`touched4_ref`."""
    dev = _device_of(scal, "touched4")
    if dev.type == "cpu":
        return touched4_ref(scal, origins, dirs, active, height=height,
                            width=width)
    _check(dev, [("scal", scal, torch.float32, (N_SCAL,))]
           + _bundle_checks(origins, dirs, active, height, width))
    marks = torch.empty((-(-height // TILE_H), -(-width // TILE_W)),
                        dtype=torch.uint8, device=dev)
    _run(dev, "touched4", _build.load("planes4").touched4_launch,
         scal.data_ptr(), *_bundle_ptrs(origins, dirs, active),
         marks.data_ptr(), height, width)
    touched4.launches += 1
    return marks


touched4.launches = 0  # kernel launches since the last reset


def march_planes4(scal, gw2, sw_cont, wmeta_pad, origins=None, dirs=None,
                  active=None, *, height, width, sparse_ns=0):
    """State-plane v4 march -> ``(ts, fl, wa, we)``, each [height, width].

    On CUDA tensors: :func:`touched4`, then one launch of
    ``march_planes4_kernel`` in ``csrc/planes4.cu`` (its sparse
    instantiation when ``sparse_ns`` > 0), both on the current stream; on
    CPU tensors: the plain version :func:`march_planes4_ref`. Any other
    device raises. Same arguments as :func:`march_planes4_ref`."""
    dev = _device_of(sw_cont, "march_planes4")
    if dev.type == "cpu":
        return march_planes4_ref(scal, gw2, sw_cont, wmeta_pad, origins,
                                 dirs, active, height=height, width=width,
                                 sparse_ns=sparse_ns)
    nw, ns, gs = _world_dims(sw_cont, wmeta_pad, sparse_ns)
    _check(dev, _table_args(scal, gw2, sw_cont, wmeta_pad, sparse_ns))
    # touched4 checks the bundle before either kernel launches
    marks = touched4(scal, origins, dirs, active, height=height, width=width)
    f32 = dict(dtype=torch.float32, device=dev)
    ts, wa, we = (torch.empty((height, width), **f32) for _ in range(3))
    fl = torch.empty((height, width), dtype=torch.int32, device=dev)
    _run(dev, "march_planes4", _build.load("planes4").march_planes4_launch,
         scal.data_ptr(), gw2.data_ptr(), sw_cont.data_ptr(),
         wmeta_pad.data_ptr(), *_bundle_ptrs(origins, dirs, active),
         marks.data_ptr(), ts.data_ptr(), fl.data_ptr(), wa.data_ptr(),
         we.data_ptr(), height, width, nw, ns, gs, int(bool(sparse_ns)))
    march_planes4.launches += 1
    return ts, fl, wa, we


march_planes4.launches = 0  # kernel launches since the last reset


def shade4(scal, lut, ts, fl, wa, we, sh, *, show_steps=False,
           shadows=False, max_steps=1):
    """Split shade -> packed RGBA8 i32[H, W].

    On CUDA tensors: one launch of ``csrc/shade4.cu``; on CPU tensors: the
    plain version :func:`shade4_ref`. Any other device raises. Same
    arguments as :func:`shade4_ref` (``sh`` is read only with
    ``shadows``)."""
    dev = _device_of(ts, "shade4")
    if dev.type == "cpu":
        return shade4_ref(scal, lut, ts, fl, wa, we, sh,
                          show_steps=show_steps, shadows=shadows,
                          max_steps=max_steps)
    hw = tuple(ts.shape)
    checks = [("scal", scal, torch.float32, (N_SCAL,)),
              ("lut", lut, torch.float32, (6, 128)),
              ("ts", ts, torch.float32, hw), ("fl", fl, torch.int32, hw),
              ("wa", wa, torch.float32, hw), ("we", we, torch.float32, hw)]
    if shadows:
        checks.append(("sh", sh, torch.int32, hw))
    _check(dev, checks)
    packed = torch.empty(hw, dtype=torch.int32, device=dev)
    _run(dev, "shade4", _build.load("shade4").shade4_launch,
         scal.data_ptr(), lut.data_ptr(), ts.data_ptr(), fl.data_ptr(),
         wa.data_ptr(), we.data_ptr(), sh.data_ptr() if shadows else None,
         packed.data_ptr(), hw[0], hw[1], int(bool(show_steps)),
         ctypes.c_float(float(np.float32(max_steps))))
    shade4.launches += 1
    return packed


shade4.launches = 0  # kernel launches since the last reset


# ------------------------------------------------------------------- frame


def _scal_row(rg, origin, inv_view, inv_proj, width, height, step_cap,
              full_height=None, y0=0.0):
    """Host f32[43] scalar row: ``_cam_scal`` + step cap, init flag and
    tile counts at 23-26, zeros after. ``full_height``/``y0``: the rows
    ``y0 .. y0 + height`` of a ``full_height``-row frame (a band)."""
    scal = _cam_scal(origin, inv_view, inv_proj, int(rg.size_voxels),
                     width, height if full_height is None else full_height,
                     y0)
    scal[23] = 0.0 if step_cap is None else float(step_cap)
    scal[24] = 1.0
    scal[25] = width // TILE_W
    scal[26] = height // TILE_H
    return np.concatenate([scal, np.zeros(N_SCAL - 27, np.float32)])


def _frame_scal(rg, cam, *, sky_color, sun_pos, sun_intensity,
                shadow_ambient, step_cap, sub_rounds, y0=0.0,
                band_height=None):
    """Host f32[43] scalar row of the fused frame: :func:`_scal_row`, then
    the shade parameters at the JAX kernel's indices (27-29 sun
    direction, 30 intensity, 31-33 sky, 34-36 sun position, 37 shadow
    ambient). With ``band_height``, the row of the band ``y0 .. y0 +
    band_height`` of the camera's frame."""
    f32 = np.float32
    width, full_height = cam.proj_size
    height = full_height if band_height is None else band_height
    wm = rg.world_min.cpu().numpy().astype(f32)
    origin = np.asarray(cam.pos, f32) - wm
    sun_local = np.asarray(sun_pos, f32) - wm
    scal = _scal_row(rg, origin, cam.inv_view, cam.inv_proj, width, height,
                     step_cap, full_height=full_height, y0=y0)
    scal[22] = sub_rounds
    return _shade_params(scal, origin, sun_local, sky_color=sky_color,
                         sun_intensity=sun_intensity,
                         shadow_ambient=shadow_ambient)


def _shade_params(scal, origin, sun_local, *, sky_color, sun_intensity,
                  shadow_ambient):
    """The f32[43] row of ``scal``'s first 27 entries and the shade
    parameters at the JAX kernels' indices: 27-29 the sun direction
    ``normalize(sun - origin)``, 30 intensity, 31-33 sky, 34-36 sun
    position, 37 shadow ambient (host arrays, world-local)."""
    f32 = np.float32
    row = np.zeros(N_SCAL, f32)
    row[:27] = scal[:27]
    sun_local = np.asarray(sun_local, f32).reshape(3)
    sv = sun_local - np.asarray(origin, f32).reshape(3)
    row[27:30] = sv / np.sqrt(sv[0] * sv[0] + sv[1] * sv[1] + sv[2] * sv[2])
    row[30] = sun_intensity
    row[31:34] = np.asarray(sky_color, f32).reshape(3)
    row[34:37] = sun_local
    row[37] = shadow_ambient
    return row


def _tables(rg, prepared):
    """Pair plane, packed tables (dense, or the sparse token's) and the
    token's ``sparse_ns`` (0: dense) of a grid, on its device."""
    if prepared is None:
        prepared = prepare_grid4(rg)
    return (_interleave_gw(rg.gw_jump, rg.gw_liq).contiguous(),
            prepared.sw_cont, prepared.wmeta_pad, _sparse_ns(prepared))


def _frame_dims(width, height):
    """[height, width] of the image: the JAX frame untiles a padded
    superblock grid and crops it to [height, width]; pixels past that
    grid do not exist."""
    nsx, nsy, _ = _sb_dims(width // TILE_W, height // TILE_H)
    return min(height, nsy * SB_H * TILE_H), min(width, nsx * SB_W * TILE_W)


def _frame_inputs(rg, cam, materials_color, *, sky_color, sun_pos,
                  sun_intensity, shadow_ambient, show_steps, shadows, rounds,
                  steps_per_round, step_cap, prepared, y0=0.0,
                  band_height=None):
    """``(scal, args, kw)`` of one frame, or of the band ``y0 .. y0 +
    band_height`` of it: the host f32[43] scalar row (:func:`_frame_scal`),
    the rest of :func:`frame_args`' arguments on the grid's device, and
    its keywords."""
    width, height = cam.proj_size
    if band_height is not None:
        height = band_height
    device = rg.sw_solid.device
    sub_steps = 8
    sub_rounds = max(steps_per_round // sub_steps, 1)
    scal = _frame_scal(rg, cam, sky_color=sky_color, sun_pos=sun_pos,
                       sun_intensity=sun_intensity,
                       shadow_ambient=shadow_ambient, step_cap=step_cap,
                       sub_rounds=sub_rounds, y0=y0, band_height=band_height)
    if getattr(materials_color, "shape", None) == (6, 128):
        lut = torch.as_tensor(materials_color)
    else:
        lut = color_lut_rows(materials_color)
    gw2, sw_cont, wmeta_pad, sparse_ns = _tables(rg, prepared)
    args = (gw2, lut.to(device=device, dtype=torch.float32).contiguous(),
            sw_cont, wmeta_pad)
    h, w = _frame_dims(width, height)
    kw = dict(height=h, width=w, show_steps=bool(show_steps),
              max_steps=rounds * sub_rounds * sub_steps,
              shadows=bool(shadows), sparse_ns=sparse_ns)
    return scal, args, kw


def frame_args(rg: RenderGrid3, cam, materials_color, *,
               sky_color=(0.81, 0.93, 1.0), sun_pos=(0.0, 10_000.0, 0.0),
               sun_intensity=4.0, shadow_ambient=0.4, show_steps=False,
               shadows=False, rounds=64, steps_per_round=128, step_cap=None,
               prepared=None):
    """The :func:`march_fused4` arguments of one frame, ``(args, kwargs)``,
    on the grid's device: the host-computed f32[43] scalar row
    (:func:`_frame_scal`), the global pair plane, the color LUT and the
    packed tables. Keywords as in :func:`render_frame4`."""
    scal, args, kw = _frame_inputs(
        rg, cam, materials_color, sky_color=sky_color, sun_pos=sun_pos,
        sun_intensity=sun_intensity, shadow_ambient=shadow_ambient,
        show_steps=show_steps, shadows=shadows, rounds=rounds,
        steps_per_round=steps_per_round, step_cap=step_cap,
        prepared=prepared)
    return (torch.from_numpy(scal).to(rg.sw_solid.device), *args), kw


def _shadow_prep4(ts, fl, scal):
    """Per-ray shadow bundle from the primary march's raw planes
    (wavefront4.py:_shadow_prep4): hit point (normal-nudged) -> sun
    direction, active where hit. ``scal`` is the frame's f32[43] row
    (camera at 0-26, sun position at 34-36). Returns origins and
    directions f32[H, W, 3] and the active mask bool[H, W]."""
    height, width = ts.shape
    sf = [float(x) for x in np.asarray(scal, np.float32)]
    pxi, pyi = _pixels(height, width, ts.device)
    dx, dy, dz = _camera_rays(sf, pxi, pyi)[3:]
    f = fl.reshape(-1)
    rays = _shadow_rays(sf, dx, dy, dz, ts.reshape(-1), (f >> _FL_AX) & 7)
    ot = torch.stack(rays[:3], dim=-1).reshape(height, width, 3)
    dt3 = torch.stack(rays[3:], dim=-1).reshape(height, width, 3)
    return ot, dt3, ((fl >> _FL_HIT) & 1) != 0


def _split_shade_row(scal):
    """The split shade's f32[43] row from the fused frame row (host
    arrays): ``_cam_scal`` + sun direction, intensity and sky as before,
    the shadow ambient moved from 37 to 34, zeros after
    (wavefront4.py:_shade_fin4)."""
    return np.concatenate([scal[:34], scal[37:38],
                           np.zeros(N_SCAL - 35, np.float32)])


def _shade_fin4(scal, lut, ts, fl, wa, we, sh_fl, *, shadows, show_steps,
                max_steps):
    """The split shade of one frame (wavefront4.py:_shade_fin4) from the
    fused frame's host row ``scal``; the shadow plane is the shadow leg's
    hit bit."""
    sh = ((sh_fl >> _FL_HIT) & 1) if shadows else None
    return shade4(torch.from_numpy(_split_shade_row(scal)).to(ts.device),
                  lut, ts, fl, wa, we, sh, show_steps=show_steps,
                  shadows=shadows, max_steps=max_steps)


def _render_frame4(row, gw2, lut, sw_cont, wmeta_pad, *, height, width,
                   show_steps, max_steps, shadows, sparse_ns):
    """The split v4 frame on the host f32[43] row ``row`` of
    :func:`_frame_inputs` (wavefront4.py:_render_frame4): the state-plane
    march of the camera rays, with ``shadows`` the shadow bundle's march,
    then the split shade; a band's row (``scal[21]`` its first row,
    ``scal[5]`` 2 over the full frame's height) draws that band. Returns
    the packed RGBA8 and flags images [height, width]."""
    scal = torch.from_numpy(row).to(sw_cont.device)
    dims = dict(height=height, width=width, sparse_ns=sparse_ns)
    ts, fl, wa, we = march_planes4(scal, gw2, sw_cont, wmeta_pad, **dims)
    sh_fl = None
    if shadows:
        ot, dt3, hitm = _shadow_prep4(ts, fl, row)
        sh_fl = march_planes4(scal, gw2, sw_cont, wmeta_pad, ot, dt3, hitm,
                              **dims)[1]
    img = _shade_fin4(row, lut, ts, fl, wa, we, sh_fl, shadows=shadows,
                      show_steps=show_steps, max_steps=max_steps)
    return img, fl


def render_frame4(
    rg: RenderGrid3,
    cam,
    materials_color,
    *,
    sky_color=(0.81, 0.93, 1.0),
    sun_pos=(0.0, 10_000.0, 0.0),
    sun_intensity=4.0,
    shadows=False,
    shadow_ambient=0.4,
    show_steps=False,
    rounds=64,
    steps_per_round=128,
    step_cap=None,
    with_flags=False,
    cache=None,
    return_cache=False,
    prepared=None,
    fused=False,
    s_seg=1,
):
    """One shaded frame -> packed RGBA8 ``i32[H,W]``.

    The signature of the JAX ``render_frame4``. ``fused=True``: the whole
    frame is one launch (:func:`march_fused4`), which generates the camera
    rays, marches, decodes hit ids, runs the shadow leg when ``shadows``
    and shades. ``fused=False``: the split path — the state-plane march
    of the camera rays (:func:`march_planes4`), with shadows
    :func:`_shadow_prep4` and a second state-plane march of the shadow
    bundle, then :func:`shade4`. Both paths give the same frame for a
    camera inside the world; for a camera outside it the split path, as
    in JAX, shades the untouched zero planes. Returns ``img`` or ``(img,
    flags)`` with ``with_flags``, plus the cache token pair when
    ``return_cache``. Runs on the device of the grid's tensors.

    ``rounds`` and ``steps_per_round`` only set the step-heatmap scale of
    ``show_steps`` (``rounds * (steps_per_round // 8) * 8``): on the TPU
    they bound the in-kernel serve rounds, which the port does not have.
    The warm tokens ``cache``/``return_cache`` keep their JAX shape,
    i32[nB,2,128] of -1 (i32[nB,3,128] for sparse tables): on Hopper there
    is no per-block cache to warm, so they are inert, and callers unpack
    them unchanged. ``s_seg`` (subwindow rows per serve DMA) is TPU
    schedule: accepted because bench.py passes it, and ignored.
    ``prepared=None`` packs the tables first; ``prepared`` may be a
    :class:`PreparedGrid4Sparse`, which every path marches through its
    sparse kernels. A grid with ``palettes_ok=False`` renders, its
    overflowed ids taking their subwindow's most frequent entry, as in
    JAX.
    """
    del s_seg  # TPU serve schedule: no meaning for the per-ray march
    if not rg.palettes_ok:
        _log.warning(
            "rendering with overflowed subwindow palettes: a few voxels in "
            ">16-solid-id regions take the most-frequent entry's color")
    row, (gw2, lut, sw_cont, wmeta_pad), kw = _frame_inputs(
        rg, cam, materials_color, sky_color=sky_color,
        sun_pos=sun_pos, sun_intensity=sun_intensity,
        shadow_ambient=shadow_ambient, show_steps=show_steps,
        shadows=shadows, rounds=rounds, steps_per_round=steps_per_round,
        step_cap=step_cap, prepared=prepared)
    if fused:
        img, fl = march_fused4(torch.from_numpy(row).to(sw_cont.device), gw2,
                               lut, sw_cont, wmeta_pad, **kw)
    else:
        img, fl = _render_frame4(row, gw2, lut, sw_cont, wmeta_pad, **kw)
    ret = (img, fl) if with_flags else (img,)
    if return_cache:
        tok = _token(cam.proj_size, img.device, kw["sparse_ns"])
        passed = None if cache is None else cache[1]
        ret = ret + ((tok, tok if shadows and not fused else passed),)
    return ret if len(ret) > 1 else ret[0]


def _token(proj_size, device, sparse_ns=0):
    """The inert warm token of a frame: i32[nB,2,128] of -1, with a third
    row (the JAX kernel's content-row indices) for sparse tables."""
    width, height = proj_size
    _, _, T = _sb_dims(width // TILE_W, height // TILE_H)
    return torch.full((T // _BLK, 3 if sparse_ns else 2, 128), -1,
                      dtype=torch.int32, device=device)


# ------------------------------------------------------------------- trace


def _trace_frame4(rg, origin, inv_view, inv_proj, origins3=None, dirs3=None,
                  active0=None, *, width, height, step_cap=None,
                  raw_out=False, prepared=None):
    """One state-plane march of a frame's rays (wavefront4.py:
    _trace_frame4): camera rays from ``origin`` (world-local) and the
    camera matrices, or per-ray bundles ``origins3``/``dirs3``
    f32[H,W,3] with ``active0`` bool[H,W].

    ``raw_out=True`` returns the raw planes ``(ts, fl, wa, we)`` in image
    order [H, W] (JAX returns them tiled [T,128]); else a
    :class:`WavefrontResult` of hit, pack voxel id, normal, ``t`` (the raw
    carry), water length (open interval closed at ``t``) and steps."""
    f32 = torch.float32
    device = rg.sw_solid.device
    scal = _scal_row(rg, np.asarray(origin, np.float32), inv_view, inv_proj,
                     width, height, step_cap)
    gw2, sw_cont, wmeta_pad, sparse_ns = _tables(rg, prepared)
    h, w = _frame_dims(width, height)
    bundle = ()
    if origins3 is not None:
        bundle = tuple(
            torch.as_tensor(x, device=device).to(dt).expand(shape).contiguous()
            for x, dt, shape in ((origins3, f32, (h, w, 3)),
                                 (dirs3, f32, (h, w, 3)),
                                 (active0, torch.bool, (h, w))))
    ts, fl, wa, we = march_planes4(torch.from_numpy(scal).to(device), gw2,
                                   sw_cont, wmeta_pad, *bundle, height=h,
                                   width=w, sparse_ns=sparse_ns)
    if raw_out:
        return ts, fl, wa, we
    return _trace_result(ts, fl, wa, we)


def _trace_result(ts, fl, wa, we):
    """The :class:`WavefrontResult` of a state-plane march's raw planes
    (wavefront4.py:1739-1765): hit, pack voxel id, normal, ``t`` (the raw
    carry), water length (open interval closed at ``t``) and steps."""
    f32 = torch.float32
    hit = ((fl >> _FL_HIT) & 1) != 0
    axmask = (fl >> _FL_AX) & 7
    sgnb = (fl >> _FL_SGN) & 7
    water = wa + torch.where(we >= 0.0, ts - we, 0.0)
    norm = torch.stack(
        [-torch.where((sgnb & (1 << i)) != 0, 1.0, -1.0)
         * ((axmask >> i) & 1).to(f32) for i in range(3)], dim=-1)
    return WavefrontResult(
        hit=hit, voxel=torch.where(hit, (fl >> _FL_VOX) & 0xFF, 0),
        norm=norm, t=ts, water_dist=water, steps=(fl >> _FL_STP) & 0xFFF)


def trace_wavefront4(rg: RenderGrid3, origin, *, cam=None, width=None,
                     height=None, rounds=64, steps_per_round=128,
                     step_cap=None, cache=None, return_cache=False,
                     prepared=None):
    """March one frame of camera rays -> :class:`WavefrontResult`
    ([H, W] planes on the grid's device).

    The signature of the JAX ``trace_wavefront4``: ``origin`` is the
    world-local camera position (``generate_rays``' origin), ``cam`` the
    CamData. ``rounds``/``steps_per_round`` bound the TPU's serve rounds
    and mean nothing here. ``prepared`` may be dense or a
    :class:`PreparedGrid4Sparse`. ``cache``/``return_cache``: the warm
    token keeps its JAX shape i32[nB,2,128] (3 rows for sparse tables) and
    is inert; ``return_cache=True`` returns ``(result, token)``.
    """
    del rounds, steps_per_round  # TPU serve schedule
    if cam is None:
        raise ValueError("trace_wavefront4 needs cam=CamData")
    if width is None or height is None:
        width, height = cam.proj_size
    _require_tiles(width, height)
    res = _trace_frame4(rg, origin, cam.inv_view, cam.inv_proj, width=width,
                        height=height, step_cap=step_cap, prepared=prepared)
    if return_cache:
        return res, _token((width, height), res.t.device, _sparse_ns(prepared))
    return res


def trace_wavefront4_rays(rg: RenderGrid3, origins, dirs, active, *, width,
                          height, rounds=64, steps_per_round=128,
                          step_cap=None):
    """Per-ray (origin, direction) bundles through the v4 march — the
    secondary-ray path (shadows, bounces) -> :class:`WavefrontResult`.

    The signature of the JAX ``trace_wavefront4_rays``: ``origins`` and
    ``dirs`` f32[H,W,3] (world-local; broadcastable), ``active``
    bool[H,W]. A ray marches if it is active, its tile is whole and its
    origin lies strictly inside the world. ``rounds``/``steps_per_round``
    bound the TPU's serve rounds and mean nothing here."""
    del rounds, steps_per_round  # TPU serve schedule
    _require_tiles(width, height)
    eye = np.eye(4, dtype=np.float32)
    return _trace_frame4(rg, np.zeros(3, np.float32), eye, eye, origins,
                         dirs, active, width=width, height=height,
                         step_cap=step_cap)
