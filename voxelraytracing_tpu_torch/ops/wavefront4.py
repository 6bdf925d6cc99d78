"""The v4 primary frame: one launch that marches the bit-plane world and
shades each pixel to packed RGBA8.

Port of the fused primary mode of ``voxelraytracing_tpu/ops/wavefront4.py``
(``render_frame4(fused=True)`` -> ``_frame_fused4`` -> one launch of
``_march_kernel4``). The JAX kernel serves subwindow rows to a per-block
VMEM cache in rounds; that service is TPU schedule and changes no pixel
(tests/test_wavefront4.py pins it), so the port keeps only the per-ray
semantics: each ray marches on its own until it hits, leaves the world or
the slab, or reaches the step cap.

  * :func:`march_fused4_ref` — the plain PyTorch version: one masked step
    of every live ray per loop iteration, on any device.
  * :func:`march_fused4` — the wrapper: on a CUDA tensor it launches the
    hand-written kernel ``csrc/march4.cu``; on a CPU tensor it runs the
    plain version.
  * :func:`render_frame4` — the frame entry point with the JAX signature.

Bit words are int32 tensors holding the JAX package's uint32 bits; every
right shift is masked, since ``>>`` sign-extends words with bit 31 set.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .wavefront import BRICK, EPS_T, TILE_H, TILE_W, _BIG, _BIG_IV
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
    RenderGrid3,
    _cam_scal,
    _gs_for,
    _pixel_dirs,
    _sb_dims,
    color_lut_rows,
)

N_SCAL = 43  # scalar row: _cam_scal's 27 + shade params (see render_frame4)


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


def _world_dims(sw_cont, wmeta_pad):
    """(nw, ns, gs) of a dense table pair."""
    ns = _cube_root(sw_cont.shape[0])
    nw = _cube_root(wmeta_pad.shape[0])
    if ns != 4 * nw:
        raise ValueError(f"{ns} subwindows per axis for {nw} windows")
    return nw, ns, _gs_for(nw)


# ------------------------------------------------------------- plain version


class MarchState(NamedTuple):
    """Per-ray products of the plain march, flat over ``height*width``
    pixels: direction, final ``t`` (clamped to the slab exit ``t_exit``),
    hit, exit-axis mask, hit id, water length (interval closed at ``t``),
    open-interval start ``wenter`` and step count."""

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


def march_ref(scal, gw2, sw_cont, wmeta_pad, *, height, width):
    """The march of :func:`march_fused4_ref`, without the shade.

    Per ray, in the JAX kernel's op order (wavefront4.py:_march_kernel4):
    camera ray, slab exit, then steps classified from position alone —
    global window (super-cell) jump, subwindow jump from the window meta,
    brick skip from the subwindow meta, else a voxel bit test — each
    advancing by the DDA exit of its cell plus EPS_T, with the water
    interval tracked, until hit, exit or ``stp >= step_cap``. Hit ids
    decode from the 4 palette-index planes and the subwindow palette.
    Every multiply and add rounds on its own, as in the CUDA kernel.
    """
    dev = sw_cont.device
    f32, i32 = torch.float32, torch.int32
    nw, ns, gs = _world_dims(sw_cont, wmeta_pad)
    nwg = (nw + (1 << gs) - 1) >> gs
    s = scal.detach().cpu().numpy().astype(np.float32)
    sf = [float(x) for x in s]
    ox, oy, oz, v = sf[0], sf[1], sf[2], sf[3]
    step_cap = int(s[23]) if s[23] > 0.5 else 1_000_000_000
    gw_flat = gw2.reshape(-1)
    wm_flat = wmeta_pad.reshape(-1)
    swc_flat = sw_cont.reshape(-1)

    pyi, pxi = torch.meshgrid(
        torch.arange(height, dtype=i32, device=dev),
        torch.arange(width, dtype=i32, device=dev), indexing="ij")
    pxi, pyi = pxi.reshape(-1), pyi.reshape(-1)
    dx, dy, dz = _pixel_dirs(sf, pxi.to(f32), pyi.to(f32) + sf[21])

    def inv(c):
        c2 = torch.where(c >= 0.0, torch.clamp_min(c, 1e-7),
                         torch.clamp_max(c, -1e-7))
        return 1.0 / c2

    ivx, ivy, ivz = inv(dx), inv(dy), inv(dz)
    sgn = [(d > 0.0).to(f32) for d in (dx, dy, dz)]
    sgf = [sc + sc - 1.0 for sc in sgn]                     # ±1 exactly
    ivs = [ivx * sgf[0], ivy * sgf[1], ivz * sgf[2]]
    big = [iv.abs() >= 0.99 * _BIG_IV for iv in (ivx, ivy, ivz)]

    def slab(oc, ivc):
        lo = float(np.float32(0.0) - np.float32(oc))
        hi = float(np.float32(v) - np.float32(oc))
        return torch.maximum(lo * ivc, hi * ivc)

    t_cap = float(np.float32(4.0) * np.float32(v) + np.float32(16.0))
    t_exit = torch.clamp_max(
        torch.minimum(slab(ox, ivx), torch.minimum(slab(oy, ivy), slab(oz, ivz))),
        t_cap)

    n = pxi.numel()
    val_t = ((pxi // TILE_W).to(f32) < sf[25]) & ((pyi // TILE_H).to(f32) < sf[26])
    in_w0 = (ox > 0.0) and (ox < v) and (oy > 0.0) and (oy < v) \
        and (oz > 0.0) and (oz < v)
    t = torch.full((n,), EPS_T, dtype=f32, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    axm = torch.zeros(n, dtype=i32, device=dev)
    water = torch.zeros(n, dtype=f32, device=dev)
    wenter = torch.full((n,), -1.0, dtype=f32, device=dev)
    stp = torch.zeros(n, dtype=i32, device=dev)
    active = val_t & bool(in_w0 and 0 < step_cap)

    # The live set: ray indices plus their per-ray constants and state,
    # compacted every step so finished rays cost nothing.
    idx = torch.nonzero(active).squeeze(1)
    const = [c[idx] for c in (dx, dy, dz, *sgf, *ivs, *big, t_exit)]
    st = [x[idx] for x in (t, hit, axm, water, wenter, stp)]
    while idx.numel():
        # a ray stops once it hit, left the slab or the world, or used up
        # its steps; stopped rays write their state back and leave the set
        pos = [o + d * st[0] for o, d in zip((ox, oy, oz), const[:3])]
        alive = ~st[1] & (st[0] < const[12]) & (st[5] < step_cap)
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
        cdx, cdy, cdz, gfx, gfy, gfz, isx, isy, isz, bgx, bgy, bgz, _ = const
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
        g_pair = (gw_flat[(wg >> 4).long()] >> ((wg & 15) * 2)) & 3
        s_loc = ((vx >> 4) & 3) + ((vy >> 4) & 3) * 4 + ((vz >> 4) & 3) * 16
        w_word = wm_flat[(w.long() * 128 + (s_loc >> 4).long())]
        sw_pair = (w_word >> ((s_loc & 15) * 2)) & 3
        sid = (vx >> 4) + (vy >> 4) * ns + (vz >> 4) * (ns * ns)
        base = sid.long() * (7 * 128)
        b_loc = ((vx >> 2) & 3) + ((vy >> 2) & 3) * 4 + ((vz >> 2) & 3) * 16
        b_word = swc_flat[base + 6 * 128 + (b_loc >> 4).long()]
        br_pair = (b_word >> ((b_loc & 15) * 2)) & 3
        l = (vx & 15) + (vy & 15) * 16 + (vz & 15) * 256
        lw = base + (l >> 5).long()
        vsolid = ((swc_flat[lw] >> (l & 31)) & 1) != 0
        vliq = ((swc_flat[lw + 128] >> (l & 31)) & 1) != 0

        case1 = (g_pair & 1) != 0
        case2 = ~case1 & ((sw_pair & 1) != 0)
        case3 = ~case1 & ~case2
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

    t = torch.minimum(t, t_exit)

    # hit ids: 4 palette-index bits + the palette byte of the subwindow
    vox = torch.zeros(n, dtype=i32, device=dev)
    hi_idx = torch.nonzero(hit).squeeze(1)
    if hi_idx.numel():
        th = t[hi_idx]
        vx = torch.floor(ox + dx[hi_idx] * th).to(i32)
        vy = torch.floor(oy + dy[hi_idx] * th).to(i32)
        vz = torch.floor(oz + dz[hi_idx] * th).to(i32)
        sid = (vx >> 4) + (vy >> 4) * ns + (vz >> 4) * (ns * ns)
        base = sid.long() * (7 * 128)
        l = (vx & 15) + (vy & 15) * 16 + (vz & 15) * 256
        lw = base + (l >> 5).long()
        pidx = torch.zeros_like(l)
        for b in range(4):
            pidx = pidx | (((swc_flat[lw + (2 + b) * 128] >> (l & 31)) & 1) << b)
        pal_w = swc_flat[base + 6 * 128 + 4 + (pidx >> 2).long()]
        vox[hi_idx] = (pal_w >> ((pidx & 3) * 8)) & 0xFF

    water = water + torch.where(wenter >= 0.0, t - wenter, 0.0)
    return MarchState(dx, dy, dz, t, t_exit, hit, axm, vox, water, wenter, stp)


def march_fused4_ref(scal, gw2, lut, sw_cont, wmeta_pad, *, height, width,
                     show_steps=False, max_steps=1):
    """Plain PyTorch version of the fused v4 march + shade.

    ``scal`` f32[43] (see :func:`frame_args`), ``gw2`` i32[2,128] pair
    plane, ``lut`` f32[6,128], ``sw_cont`` i32[Ns³,7,128], ``wmeta_pad``
    i32[Nw³,1,128], all on one device. Returns ``(packed, flags)``, both
    i32[height, width]: packed RGBA8 and the flags word of each pixel.
    """
    m = march_ref(scal, gw2, sw_cont, wmeta_pad, height=height, width=width)
    sf = [float(x) for x in scal.detach().cpu().numpy()]
    packed = _shade_ref(sf, lut.reshape(-1), m, show_steps, max_steps)
    i32 = torch.int32
    sgn = ((m.dx > 0.0).to(i32) | ((m.dy > 0.0).to(i32) << 1)
           | ((m.dz > 0.0).to(i32) << 2))
    flags = (
        (m.hit.to(i32) << _FL_HIT)
        | (m.axm << _FL_AX)
        | (torch.clamp_max(m.stp, 0xFFF) << _FL_STP)
        | (m.vox << _FL_VOX)
        | (sgn << _FL_SGN)
    )
    return packed.reshape(height, width), flags.reshape(height, width)


def _shade_ref(sf, lut_flat, m, show_steps, max_steps):
    """Shade epilogue in the JAX kernel's op order (shade_store,
    wavefront4.py:909-993) -> packed RGBA8 words."""
    f32, i32 = torch.float32, torch.int32
    dx, dy, dz, hit, axm, water, stp = m.dx, m.dy, m.dz, m.hit, m.axm, m.water, m.stp
    cr, cg, cb = (lut_flat[ch * 256 + m.vox.long()] for ch in range(3))
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
        return (torch.clamp(c, 0.0, 1.0) * 255.0).to(i32)

    return q8(r) | (q8(g) << 8) | (q8(b) << 16) | -0x1000000


# ------------------------------------------------------------------ kernel


def march_fused4(scal, gw2, lut, sw_cont, wmeta_pad, *, height, width,
                 show_steps=False, max_steps=1):
    """Fused v4 march + shade -> ``(packed, flags)`` i32[height, width].

    On CUDA tensors: one launch of the hand-written kernel
    ``csrc/march4.cu`` (built at first use); on CPU tensors: the plain
    version :func:`march_fused4_ref`. Any other device raises. Same
    arguments as :func:`march_fused4_ref`."""
    dev = sw_cont.device
    if dev.type == "cpu":
        return march_fused4_ref(scal, gw2, lut, sw_cont, wmeta_pad,
                                height=height, width=width,
                                show_steps=show_steps, max_steps=max_steps)
    if dev.type != "cuda":
        raise ValueError(f"march_fused4 runs on cuda or cpu, not {dev}")
    nw, ns, gs = _world_dims(sw_cont, wmeta_pad)
    args = (("scal", scal, torch.float32, (N_SCAL,)),
            ("gw2", gw2, torch.int32, (2, 128)),
            ("lut", lut, torch.float32, (6, 128)),
            ("sw_cont", sw_cont, torch.int32, (ns ** 3, 7, 128)),
            ("wmeta_pad", wmeta_pad, torch.int32, (nw ** 3, 1, 128)))
    for name, x, dtype, shape in args:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dtype}{list(shape)} on {dev}, got "
                f"{x.dtype}{list(x.shape)} on {x.device}")
    packed = torch.empty((height, width), dtype=torch.int32, device=dev)
    flags = torch.empty((height, width), dtype=torch.int32, device=dev)
    lib = _build.load("march4")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.march_fused4_launch(
            scal.data_ptr(), gw2.data_ptr(), lut.data_ptr(),
            sw_cont.data_ptr(), wmeta_pad.data_ptr(),
            packed.data_ptr(), flags.data_ptr(),
            height, width, nw, ns, gs, int(bool(show_steps)),
            ctypes.c_float(float(np.float32(max_steps))), stream)
    if rc != 0:
        raise RuntimeError(f"march_fused4 launch failed: cudaError {rc}")
    march_fused4.launches += 1
    return packed, flags


march_fused4.launches = 0  # kernel launches since the last reset


# ------------------------------------------------------------------- frame


def frame_args(rg: RenderGrid3, cam, materials_color, *,
               sky_color=(0.81, 0.93, 1.0), sun_pos=(0.0, 10_000.0, 0.0),
               sun_intensity=4.0, shadow_ambient=0.4, show_steps=False,
               rounds=64, steps_per_round=128, step_cap=None, prepared=None):
    """The :func:`march_fused4` arguments of one frame, ``(args, kwargs)``,
    on the grid's device: the host-computed f32[43] scalar row (``_cam_scal``
    + step cap, tile counts and the shade parameters at the JAX kernel's
    indices), the global pair plane, the color LUT and the packed tables.
    Keywords as in :func:`render_frame4`."""
    f32 = np.float32
    width, height = cam.proj_size
    device = rg.sw_solid.device
    wm = rg.world_min.cpu().numpy().astype(f32)
    origin = np.asarray(cam.pos, f32) - wm
    sun_local = np.asarray(sun_pos, f32) - wm
    sub_steps = 8
    sub_rounds = max(steps_per_round // sub_steps, 1)
    tx, ty = width // TILE_W, height // TILE_H
    nsx, nsy, _ = _sb_dims(tx, ty)

    scal = _cam_scal(origin, cam.inv_view, cam.inv_proj, int(rg.size_voxels),
                     width, height, 0.0)
    scal[22] = sub_rounds
    scal[23] = 0.0 if step_cap is None else float(step_cap)
    scal[24] = 1.0
    scal[25] = tx
    scal[26] = ty
    sv = sun_local - origin
    sun_dir = sv / np.sqrt(sv[0] * sv[0] + sv[1] * sv[1] + sv[2] * sv[2])
    scal = np.concatenate([
        scal, sun_dir.astype(f32), np.asarray([sun_intensity], f32),
        np.asarray(sky_color, f32).reshape(3),
        # 34-37: sun position + shadow ambient, read by the shadow leg
        sun_local.reshape(3), np.asarray([shadow_ambient], f32),
        np.zeros(5, f32),
    ]).astype(f32)

    if getattr(materials_color, "shape", None) == (6, 128):
        lut = torch.as_tensor(materials_color)
    else:
        lut = color_lut_rows(materials_color)
    if prepared is None:
        prepared = prepare_grid4(rg)
    args = (
        torch.from_numpy(scal).to(device),
        _interleave_gw(rg.gw_jump, rg.gw_liq).contiguous(),
        lut.to(device=device, dtype=torch.float32).contiguous(),
        prepared.sw_cont, prepared.wmeta_pad,
    )
    # the JAX frame untiles a padded superblock grid and crops it to
    # [height, width]; pixels past that grid do not exist
    kw = dict(height=min(height, nsy * SB_H * TILE_H),
              width=min(width, nsx * SB_W * TILE_W),
              show_steps=bool(show_steps),
              max_steps=rounds * sub_rounds * sub_steps)
    return args, kw


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
    """One shaded primary frame -> packed RGBA8 ``i32[H,W]``.

    The signature of the JAX ``render_frame4``, for ``fused=True``: the
    whole frame is one launch of the v4 march, which generates the camera
    rays, marches, decodes hit ids and shades. Returns ``img`` or
    ``(img, flags)`` with ``with_flags``, plus the cache token pair when
    ``return_cache``. Runs on the device of the grid's tensors.

    ``rounds`` and ``steps_per_round`` only set the step-heatmap scale of
    ``show_steps`` (``rounds * (steps_per_round // 8) * 8``): on the TPU
    they bound the in-kernel serve rounds, which the port does not have.
    The warm token ``cache``/``return_cache`` keeps its JAX shape,
    i32[nB,2,128] of -1: on Hopper there is no per-block cache to warm,
    so it is inert, and callers unpack it unchanged. ``s_seg`` (subwindow
    rows per serve DMA) is TPU schedule: accepted because bench.py passes
    it, and ignored. ``prepared=None`` packs the tables first.
    """
    del s_seg  # TPU serve schedule: no meaning for the per-ray march
    if not fused:
        raise NotImplementedError(
            "render_frame4(fused=False): the split march|shade path is "
            "ROADMAP queue 1 item 8")
    if shadows:
        raise NotImplementedError(
            "render_frame4(shadows=True): the fused shadow leg is ROADMAP "
            "queue 1 item 7")
    if not rg.palettes_ok:
        raise NotImplementedError(
            "palettes_ok=False: the brick-gather hit-id fallback is not "
            "ported (ROADMAP queue 1 item 2)")
    args, kw = frame_args(
        rg, cam, materials_color, sky_color=sky_color,
        sun_pos=sun_pos, sun_intensity=sun_intensity,
        shadow_ambient=shadow_ambient, show_steps=show_steps, rounds=rounds,
        steps_per_round=steps_per_round, step_cap=step_cap,
        prepared=prepared)
    img, fl = march_fused4(*args, **kw)
    ret = (img, fl) if with_flags else (img,)
    if return_cache:
        width, height = cam.proj_size
        _, _, T = _sb_dims(width // TILE_W, height // TILE_H)
        tok = torch.full((T // _BLK, 2, 128), -1, dtype=torch.int32,
                         device=img.device)
        ret = ret + ((tok, None if cache is None else cache[1]),)
    return ret if len(ret) > 1 else ret[0]
