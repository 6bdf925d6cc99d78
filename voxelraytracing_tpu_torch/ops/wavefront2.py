"""The v2 fused wavefront march over the v1 brick-window world.

Port of ``voxelraytracing_tpu/ops/wavefront2.py``: one service round of
the march (:func:`march2`, the CUDA kernel ``csrc/march2.cu``, plain
version :func:`march2_ref`), the global window planes
(:func:`_global_planes`), the host service and round loop
(:func:`_trace_frame`) and the entry point :func:`trace_wavefront2`.

A frame is ``[T, 128]`` planes of 16x8-pixel tiles in row-major tile
order (not the superblock order of the v3/v4 frames), padded to whole
programs of 256 tiles (32,768 rays). Each round the host serves every
program's wants into a small cache (8 windows' descend and liquid bit
rows, 64 bricks' content) and the march steps each program through that
cache only: a ray that needs a window or brick the cache lacks stalls
until a later round serves it. Windows with no descend brick and uniform
liquidity are summarised in two global bit rows, so open space needs no
service. The march runs every one of ``rounds`` rounds (no early exit, as
JAX's ``lax.scan``), so a frame needs no host sync; a ray still active
after the last round renders as a miss.

Bit words are ``torch.int32`` holding the JAX package's uint32 bits.
"""

import numpy as np
import torch

from .. import _build
from .wavefront import (
    BWIN,
    BWIN_VOX,
    EPS_T,
    TILE_H,
    TILE_W,
    RenderGrid,
    WavefrontResult,
    _cdiv,
)
from .wavefront3 import _axis3, _inv_dir, _slab_exit, _slot_of

_BLK = 256  # tiles per program / cache block (32K rays)
N_WCACHE = 8  # window bit-row pairs cached per program
N_BCACHE = 64  # brick content rows cached per program
_CROWS = N_BCACHE // 8  # content cache rows of 128 words
N_WANTB = 16  # uncached-brick wants emitted per tile
_BIGI = 0x3FFFFFFF  # int sentinel for min-reductions (< 2^30)
SUB_STEPS = 12  # march steps a sub-round
N_SCAL2 = 8  # scalar row: ox, oy, oz, n_liquid, v, 0, 0, 0
# state planes of a round, in the JAX kernel's order, and their dtypes
STATE = ("t", "active", "hit", "level", "cur_brick", "axmask", "vox",
         "water", "wenter", "steps")
_FLOAT_PLANES = ("t", "water", "wenter")


def _win_bits(plane, wflat):
    """Bit ``wflat`` of a global window plane ``[1,128]`` (word
    ``clip(wflat >> 5)``, bit ``wflat & 31``), as bool."""
    word = torch.clamp(wflat >> 5, 0, 127).long()
    return ((plane.reshape(128)[word] >> (wflat & 31)) & 1) != 0


def _brick_xyz(sf, dx, dy, dz, t):
    """Position at ``t`` and its brick coordinates."""
    i32 = torch.int32
    px = sf[0] + dx * t
    py = sf[1] + dy * t
    pz = sf[2] + dz * t
    bx = torch.floor(px * 0.25).to(i32)
    by = torch.floor(py * 0.25).to(i32)
    bz = torch.floor(pz * 0.25).to(i32)
    return px, py, pz, bx, by, bz


def march2_ref(scal, dx, dy, dz, gj, gl, wid, bwc, lwc, bid, cnt, t, active,
               hit, level, cur_brick, axmask, vox, water, wenter, steps, *,
               sub_rounds, nb, bg_side):
    """Plain PyTorch version of one round of the v2 march
    (wavefront2.py:_march_kernel :88, launched by _march :471).

    ``scal`` f32[8]: ox, oy, oz, n_liquid, v. ``dx, dy, dz`` f32[T,128]
    ray directions. ``gj``/``gl`` i32[1,128]: the global jumpable and
    all-liquid window bits (:func:`_global_planes`). Per program (``T /
    256`` of them): ``wid`` i32[nP,8] cached window ids (-1: empty),
    ``bwc``/``lwc`` i32[nP,8,128] their descend and liquid rows, ``bid``
    i32[nP,64] cached brick ids, ``cnt`` i32[nP,8,128] their content (16
    words a brick). The state: ``t``, ``water``, ``wenter`` f32[T,128];
    ``active``, ``hit``, ``level``, ``cur_brick``, ``axmask``, ``vox``,
    ``steps`` i32[T,128].

    Each program marches sub-rounds of ``SUB_STEPS`` steps while the
    budget lasts and ANY of its rays can march (a window or brick it
    needs is cached, or its window is uniform); every ray of a running
    program takes the steps. A program with no active ray passes its
    state through. Returns the ten state planes, ``want_win`` i32[T,1]
    (the smallest uncached window a brick-level ray of the tile stands
    in) and ``want_br`` i32[T,16] (the smallest uncached brick of each
    8-lane group), -1 for none.

    The arithmetic is the JAX kernel's, ray by ray. Only tiles holding
    an active ray are computed (an inactive ray changes nothing and adds
    nothing to a reduction), and within a sub-round only rays whose state
    still changes: a step is a function of the ray's state and its
    tile's rows, so a ray that a step leaves as it was stays so for the
    rest of the sub-round."""
    i32 = torch.int32
    dev = t.device
    sf = [float(x) for x in scal.detach().cpu().numpy().astype(np.float32)]
    n_liquid, v = int(sf[3]), sf[4]
    T = t.shape[0]
    planes = dict(zip(STATE, (t, active, hit, level, cur_brick, axmask, vox,
                              water, wenter, steps)))
    out = {k: x.clone() for k, x in planes.items()}
    want_win = torch.full((T, 1), -1, dtype=i32, device=dev)
    want_br = torch.full((T, N_WANTB), -1, dtype=i32, device=dev)
    tiles = torch.nonzero((active != 0).any(dim=1)).squeeze(1)
    n = tiles.numel()
    if n == 0:
        return tuple(out[k] for k in STATE) + (want_win, want_br)

    prog = tiles // _BLK
    R = dict(dx=dx[tiles], dy=dy[tiles], dz=dz[tiles])
    iv = [_inv_dir(R["dx"]), _inv_dir(R["dy"]), _inv_dir(R["dz"])]
    R.update(ivx=iv[0], ivy=iv[1], ivz=iv[2], sx=R["dx"] > 0.0,
             sy=R["dy"] > 0.0, sz=R["dz"] > 0.0)
    o = [torch.full_like(R["dx"], sf[i]) for i in range(3)]
    R["t_exit"] = _slab_exit(v, *o, iv)
    S = {k: planes[k][tiles].clone() for k in STATE}
    S["active"] = S["active"] != 0
    S["hit"] = S["hit"] != 0
    wid_t, bid_t = wid[prog], bid[prog]          # [n,8], [n,64]
    cnt_t = cnt.reshape(-1, N_BCACHE, 16)[prog]  # [n,64,16]

    def winpos(tt):
        px, py, pz, bx, by, bz = _brick_xyz(sf, R["dx"], R["dy"], R["dz"],
                                            tt)
        wflat = (bx >> 4) + (by >> 4) * nb + (bz >> 4) * (nb * nb)
        cached = ((wflat[:, :, None] == wid_t[:, None, :])
                  & (wid_t[:, None, :] >= 0)).any(dim=2)
        return wflat, _win_bits(gj, wflat), cached

    def boundary():
        """The tiles' rows (:186-263): window ``twid`` and its rows, the
        content row of the 8 slots, each ray's slot ``sidx``, and whether
        each program can march."""
        act, lvl, cb = S["active"], S["level"], S["cur_brick"]
        wflat, g_jump, cached = winpos(S["t"])
        wkey = torch.where(act & (lvl == 0) & ~g_jump & cached, wflat, _BIGI)
        wmin = wkey.amin(dim=1)
        twid = torch.where(wmin < _BIGI, wmin, -1)
        k = _slot_of(twid, wid_t)
        rows = [torch.where(k[:, None] >= 0, x[prog, k.clamp_min(0).long()],
                            0) for x in (bwc, lwc)]
        cidx = _slot_of(cb, bid_t[:, None, :])
        vmask = act & (lvl == 1) & (cidx >= 0)
        comb = torch.where(vmask, (cb << 6) | cidx, _BIGI)
        gmin = comb.reshape(n, 8, 16).amin(dim=2)
        ok = gmin < _BIGI
        bsel = torch.where(ok, gmin >> 6, -1)
        csel = torch.where(ok, gmin & 63, -1)
        sidx = torch.full_like(cb, -1)
        for j in range(8):
            mine = vmask & (cb == bsel[:, j:j + 1]) & (sidx < 0)
            sidx = torch.where(mine, j, sidx)
        slot = torch.gather(cnt_t, 1, csel.clamp_min(0).long()[:, :, None]
                            .expand(n, 8, 16))
        slot = torch.where(csel[:, :, None] >= 0, slot, 0).reshape(n, 128)
        can = act & (((lvl == 0) & (g_jump | (wflat == twid[:, None])))
                     | ((lvl == 1) & (sidx >= 0)))
        go = torch.zeros(T // _BLK, dtype=i32, device=dev).index_add_(
            0, prog, can.any(dim=1).to(i32)) > 0
        return dict(twid=twid, bw=rows[0], lw=rows[1], slot=slot), sidx, go

    def step(Q, rows):
        """One step of the rays of ``Q`` (:265-370)."""
        t0 = Q["t"]
        pre_level, pre_cb = Q["level"], Q["cur_brick"]
        level, cb, sidx = pre_level, pre_cb, Q["sidx"]
        px, py, pz, bx, by, bz = _brick_xyz(sf, Q["dx"], Q["dy"], Q["dz"], t0)
        lin = (bx & 15) + (by & 15) * 16 + (bz & 15) * 256
        vx = torch.floor(px).to(i32)
        vy = torch.floor(py).to(i32)
        vz = torch.floor(pz).to(i32)
        vlin = (vx & 3) + (vy & 3) * 4 + (vz & 3) * 16
        base = Q["tl"] * 128
        word = rows["bw"].reshape(-1)[base + (lin >> 5)]
        lword = rows["lw"].reshape(-1)[base + (lin >> 5)]
        vword = rows["slot"].reshape(-1)[
            base + sidx.clamp_min(0) * 16 + (vlin >> 2)]

        # brick phase (ops/wavefront.py:_post_brick)
        active = Q["active"] & (t0 < Q["t_exit"])
        fb = bx + by * bg_side + bz * (bg_side * bg_side)
        demote = active & (level == 1) & (fb != cb)
        level = torch.where(demote, 0, level)
        sidx = torch.where(demote, -1, sidx)
        bl = active & (level == 0)
        wflat = (bx >> 4) + (by >> 4) * nb + (bz >> 4) * (nb * nb)
        g_jump, g_liq = _win_bits(gj, wflat), _win_bits(gl, wflat)
        in_tile = wflat == Q["twid"]
        match_b = bl & (g_jump | in_tile)
        shift = lin & 31
        descend = ~g_jump & in_tile & (((word >> shift) & 1) != 0)
        brick_liq = torch.where(g_jump, g_liq, ((lword >> shift) & 1) != 0)
        to_voxel = match_b & descend
        level = torch.where(to_voxel, 1, level)
        cb = torch.where(to_voxel, fb, cb)
        sidx = torch.where(to_voxel, -1, sidx)
        bstep = match_b & ~descend
        wen = Q["wenter"]
        leave_b = bstep & (wen >= 0.0) & ~brick_liq
        water = Q["water"] + torch.where(leave_b, t0 - wen, 0.0)
        wen = torch.where(leave_b, -1.0, wen)
        wen = torch.where(bstep & brick_liq & (wen < 0.0), t0, wen)
        cell = torch.where(g_jump, float(BWIN_VOX), 4.0)
        icell = torch.where(g_jump, 1.0 / BWIN_VOX, 0.25)
        dtx = _axis3(px, Q["ivx"], Q["sx"], cell, icell)
        dty = _axis3(py, Q["ivy"], Q["sy"], cell, icell)
        dtz = _axis3(pz, Q["ivz"], Q["sz"], cell, icell)
        dt = torch.minimum(dtx, torch.minimum(dty, dtz))
        t1 = torch.where(bstep, t0 + dt + EPS_T, t0)
        axb = ((dtx <= dt).to(i32) | ((dty <= dt).to(i32) << 1)
               | ((dtz <= dt).to(i32) << 2))
        axm = torch.where(bstep, axb, Q["axmask"])
        stp = Q["steps"] + match_b.to(i32)

        # voxel phase (ops/wavefront.py:_post_voxel)
        px2 = sf[0] + Q["dx"] * t1
        py2 = sf[1] + Q["dy"] * t1
        pz2 = sf[2] + Q["dz"] * t1
        match_v = (active & (level == 1) & (sidx >= 0) & (pre_level == 1)
                   & (pre_cb == cb))
        vx2 = torch.floor(px2).to(i32)
        vy2 = torch.floor(py2).to(i32)
        vz2 = torch.floor(pz2).to(i32)
        vlin2 = (vx2 & 3) + (vy2 & 3) * 4 + (vz2 & 3) * 16
        rid = (vword >> ((vlin2 & 3) * 8)) & 0xFF
        is_air = rid == 0
        is_liq = (rid >= 1) & (rid <= n_liquid)
        solid = match_v & ~is_air & ~is_liq
        Q["hit"] = Q["hit"] | solid
        active = active & ~solid
        Q["vox"] = torch.where(solid, rid, Q["vox"])
        leave_v = match_v & (wen >= 0.0) & ~is_liq
        water = water + torch.where(leave_v, t1 - wen, 0.0)
        wen = torch.where(leave_v, -1.0, wen)
        Q["wenter"] = torch.where(match_v & is_liq & (wen < 0.0), t1, wen)
        Q["water"] = water
        vstep = match_v & (is_air | is_liq)
        dtx = _axis3(px2, Q["ivx"], Q["sx"], 1.0, 1.0)
        dty = _axis3(py2, Q["ivy"], Q["sy"], 1.0, 1.0)
        dtz = _axis3(pz2, Q["ivz"], Q["sz"], 1.0, 1.0)
        dt = torch.minimum(dtx, torch.minimum(dty, dtz))
        Q["t"] = torch.where(vstep, t1 + dt + EPS_T, t1)
        axv = ((dtx <= dt).to(i32) | ((dty <= dt).to(i32) << 1)
               | ((dtz <= dt).to(i32) << 2))
        Q["axmask"] = torch.where(vstep, axv, axm)
        Q["steps"] = stp + match_v.to(i32)
        changed = (Q["steps"] != Q["steps0"]) | (level != pre_level) \
            | (active != Q["active"])
        Q.update(active=active, level=level, cur_brick=cb, sidx=sidx)
        return changed

    rows, sidx, go = boundary()
    run = go
    sr = 0
    per_ray = ("dx", "dy", "dz", "ivx", "ivy", "ivz", "sx", "sy", "sz",
               "t_exit")
    while sr < sub_rounds and bool(run.any()):
        on = run[prog]                                   # [n] tiles
        flat = torch.nonzero((on[:, None] & S["active"]).reshape(-1)) \
            .squeeze(1)
        tl = (flat // 128).to(torch.int64)
        row_of = dict(twid=rows["twid"][tl], tl=tl)
        S["sidx"] = sidx
        for _ in range(SUB_STEPS):
            if not flat.numel():
                break
            Q = {k: R[k].reshape(-1)[flat] for k in per_ray}
            Q.update({k: S[k].reshape(-1)[flat] for k in STATE + ("sidx",)})
            Q.update(row_of)
            Q["steps0"] = Q["steps"]
            changed = step(Q, rows)
            for k in STATE + ("sidx",):
                S[k].reshape(-1)[flat] = Q[k]
            flat = flat[changed]
            row_of = {k: x[changed] for k, x in row_of.items()}
        rows, sidx, go = boundary()
        sr += 1
        run = run & go

    for k in STATE:
        x = S[k]
        out[k][tiles] = x if x.dtype == out[k].dtype else x.to(out[k].dtype)

    # wants (:372-405)
    act, lvl, cb = S["active"], S["level"], S["cur_brick"]
    wflat, g_jump, cached = winpos(S["t"])
    wkey = torch.where(act & (lvl == 0) & ~g_jump & ~cached, wflat, _BIGI)
    wmin = wkey.amin(dim=1, keepdim=True)
    want_win[tiles] = torch.where(wmin < _BIGI, wmin, -1)
    cidx = _slot_of(cb, bid_t[:, None, :])
    comb = torch.where(act & (lvl == 1) & (cidx < 0), cb, _BIGI)
    wb = comb.reshape(n, N_WANTB, 8).amin(dim=2)
    want_br[tiles] = torch.where(wb < _BIGI, wb, -1)
    return tuple(out[k] for k in STATE) + (want_win, want_br)


def march2(scal, dx, dy, dz, gj, gl, wid, bwc, lwc, bid, cnt, t, active, hit,
           level, cur_brick, axmask, vox, water, wenter, steps, *, sub_rounds,
           nb, bg_side):
    """One round of the v2 march -> the ten state planes, ``want_win``,
    ``want_br`` (see :func:`march2_ref`, same arguments).

    On CUDA tensors: one launch of the hand-written kernel
    ``csrc/march2.cu`` (built at first use), a cluster of eight
    1,024-thread blocks a 256-tile program (``march2.cuda_launches``
    counts launches, ``march2.launches`` calls); on CPU tensors: the
    plain version :func:`march2_ref`. Any other device raises."""
    from .wavefront4 import _check, _device_of, _run

    state = (t, active, hit, level, cur_brick, axmask, vox, water, wenter,
             steps)
    dev = _device_of(t, "march2")
    if dev.type == "cpu":
        return march2_ref(scal, dx, dy, dz, gj, gl, wid, bwc, lwc, bid, cnt,
                          *state, sub_rounds=sub_rounds, nb=nb,
                          bg_side=bg_side)
    T = t.shape[0]
    if T % _BLK:
        raise ValueError(f"{T} tiles is not a whole number of programs")
    if sub_rounds < 1:
        raise ValueError("march2 runs at least one sub-round")
    f32, i32 = torch.float32, torch.int32
    n_prog = T // _BLK
    checks = [("scal", scal, f32, (N_SCAL2,)),
              ("gj", gj, i32, (1, 128)), ("gl", gl, i32, (1, 128)),
              ("wid", wid, i32, (n_prog, N_WCACHE)),
              ("bwc", bwc, i32, (n_prog, N_WCACHE, 128)),
              ("lwc", lwc, i32, (n_prog, N_WCACHE, 128)),
              ("bid", bid, i32, (n_prog, N_BCACHE)),
              ("cnt", cnt, i32, (n_prog, _CROWS, 128))]
    checks += [(k, x, f32, (T, 128))
               for k, x in zip(("dx", "dy", "dz"), (dx, dy, dz))]
    checks += [(k, x, f32 if k in _FLOAT_PLANES else i32, (T, 128))
               for k, x in zip(STATE, state)]
    _check(dev, checks)
    out = [torch.empty_like(x) for x in state]
    want_win = torch.empty((T, 1), dtype=i32, device=dev)
    want_br = torch.empty((T, N_WANTB), dtype=i32, device=dev)
    _run(dev, "march2", _build.load("march2").march2_launch,
         *(x.data_ptr() for x in (scal, dx, dy, dz, gj, gl, wid, bwc, lwc,
                                  bid, cnt)),
         *(x.data_ptr() for x in state), *(x.data_ptr() for x in out),
         want_win.data_ptr(), want_br.data_ptr(),
         T, int(nb), int(bg_side), int(sub_rounds))
    march2.launches += 1
    march2.cuda_launches += 1
    return tuple(out) + (want_win, want_br)


march2.launches = 0  # wrapper calls (one a round) since the last reset
march2.cuda_launches = 0  # CUDA launches inside them


def _global_planes(bwin, lwin):
    """Global per-window uniformity bits (wavefront2.py:533): ``(jumpable,
    all-liquid)`` i32[1,128], window ``w`` at word ``w >> 5``, bit ``w &
    31``. A window is jumpable when it has no descend brick and uniform
    liquidity."""
    nw = bwin.shape[0]
    if nw > 4096:
        raise ValueError("the global window plane holds up to 16^3 windows")
    no_descend = (bwin == 0).all(dim=1)
    all_liq = (lwin == -1).all(dim=1)
    no_liq = (lwin == 0).all(dim=1)
    jumpable = no_descend & (all_liq | no_liq)
    sh = torch.arange(32, dtype=torch.int64, device=bwin.device)

    def pack(bits):
        pad = torch.zeros(4096, dtype=torch.int64, device=bwin.device)
        pad[:nw] = bits.to(torch.int64)
        w = (pad.reshape(128, 32) << sh).sum(dim=1)
        return torch.where(w >= 1 << 31, w - (1 << 32), w).to(
            torch.int32).reshape(1, 128)

    return pack(jumpable), pack(jumpable & all_liq)


def _world_nb(rg):
    """Windows per edge of a v1 grid."""
    nw3 = rg.bwin.shape[0]
    nb = int(round(nw3 ** (1 / 3)))
    while nb * nb * nb < nw3:
        nb += 1
    return nb


def _tile_rm(x, tx, ty, T):
    """[H, W(,C)] -> [T, 128(,C)] in v2's row-major tile order (16x8
    pixels a tile; zero rows pad to T)."""
    extra = tuple(x.shape[2:])
    ne = len(extra)
    y = x.reshape((ty, TILE_H, tx, TILE_W) + extra)
    y = y.permute((0, 2, 1, 3) + tuple(range(4, 4 + ne)))
    y = y.reshape((tx * ty, 128) + extra)
    return torch.nn.functional.pad(y, [0, 0] * ne + [0, 0, 0, T - tx * ty])


def _untile_rm(x, tx, ty, width, height):
    """Inverse of :func:`_tile_rm` (wavefront2.py:750-754)."""
    extra = tuple(x.shape[2:])
    ne = len(extra)
    y = x[:tx * ty].reshape((ty, tx, TILE_H, TILE_W) + extra)
    y = y.permute((0, 2, 1, 3) + tuple(range(4, 4 + ne)))
    return y.reshape((height, width) + extra)


def _frame_inputs(rg, origin, dirs, width, height):
    """The tiled directions, scalar row, global planes and the round-0
    carry of a frame (wavefront2.py:568-623): every ray inside the world
    starts active at ``EPS_T``; every program's window slot 0 holds the
    camera's window."""
    f32, i32 = torch.float32, torch.int32
    dev = rg.bwin.device
    tx, ty = width // TILE_W, height // TILE_H
    n_tiles = tx * ty
    T = _cdiv(n_tiles, _BLK) * _BLK
    n_prog = T // _BLK
    nb = _world_nb(rg)
    v = int(rg.size_voxels)
    origin = torch.as_tensor(origin, dtype=f32).to(dev).reshape(3)
    d = _tile_rm(torch.as_tensor(dirs, dtype=f32).to(dev), tx, ty, T)
    dx, dy, dz = (d[..., k].contiguous() for k in range(3))
    gj, gl = _global_planes(rg.bwin, rg.lwin)
    inside = ((origin > 0.0) & (origin < v)).all()
    shape = (T, 128)
    valid = torch.arange(T, device=dev)[:, None] < n_tiles
    full = dict(device=dev)
    state = dict(
        t=torch.full(shape, EPS_T, dtype=f32, **full),
        active=(inside & valid).expand(shape).to(i32).contiguous(),
        hit=torch.zeros(shape, dtype=i32, **full),
        level=torch.zeros(shape, dtype=i32, **full),
        cur_brick=torch.full(shape, -1, dtype=i32, **full),
        axmask=torch.zeros(shape, dtype=i32, **full),
        vox=torch.zeros(shape, dtype=i32, **full),
        water=torch.zeros(shape, dtype=f32, **full),
        wenter=torch.full(shape, -1.0, dtype=f32, **full),
        steps=torch.zeros(shape, dtype=i32, **full),
    )
    cam_w = torch.clamp(torch.floor(origin / float(BWIN_VOX)).to(i32), 0,
                        nb - 1)
    # a 1-element index: indexing with a 0-d tensor may read it on the host
    cam_wid = (cam_w[0] + cam_w[1] * nb + cam_w[2] * (nb * nb)).long() \
        .reshape(1)
    win_ids = torch.full((n_prog, N_WCACHE), -1, dtype=i32, **full)
    win_ids[:, 0] = cam_wid.to(i32)
    bwc = torch.zeros((n_prog, N_WCACHE, 128), dtype=i32, **full)
    lwc = torch.zeros_like(bwc)
    bwc[:, 0] = rg.bwin[cam_wid]
    lwc[:, 0] = rg.lwin[cam_wid]
    carry = dict(state=state, win_ids=win_ids, bwc=bwc, lwc=lwc,
                 want_win=torch.full((T, 1), -1, dtype=i32, **full),
                 want_br=torch.full((T, N_WANTB), -1, dtype=i32, **full))
    # made on the card, no host copy: ox, oy, oz, n_liquid, v, 0, 0, 0
    scal = torch.cat([origin] + [
        torch.full((1,), float(x), dtype=f32, device=dev)
        for x in (rg.n_liquid, v, 0, 0, 0)])
    return dict(dx=dx, dy=dy, dz=dz, gj=gj, gl=gl, scal=scal, nb=nb,
                bg_side=nb * BWIN, T=T, tx=tx, ty=ty, origin=origin), carry


def _serve(rg, c, r):
    """One round's service (wavefront2.py:625-681): up to two uncached
    window wants per program into slots 1-7 in turn (slot 0 keeps the
    camera's window), then 64 bricks picked from the programs' brick
    wants, each the first remaining want at or after a rotating offset,
    its duplicates dropped. Returns the round's cache: ``win_ids``,
    ``bwc``, ``lwc`` (carried to the next round) and ``bid``, ``cnt``."""
    i32 = torch.int32
    dev = rg.bwin.device
    n_prog = c["win_ids"].shape[0]
    rot = r * 29
    wtile = c["want_win"].reshape(n_prog, _BLK)
    cand = (wtile >= 0) & ~(wtile[:, :, None]
                            == c["win_ids"][:, None, :]).any(dim=2)
    tl = torch.arange(_BLK, device=dev)
    win_ids, bwc, lwc = (c[k].clone() for k in ("win_ids", "bwc", "lwc"))
    nw3 = rg.bwin.shape[0]
    for j in range(2):
        score = torch.where(cand, _BLK - ((tl - rot - j) % _BLK), 0)
        mx, ti = score.max(dim=1)
        wj = torch.where(mx > 0, torch.gather(wtile, 1, ti[:, None])[:, 0],
                         -1)
        cand = cand & (wtile != wj[:, None])
        slot = (2 * r + j) % (N_WCACHE - 1) + 1
        w_safe = torch.clamp(wj, 0, nw3 - 1).long()
        ins = wj >= 0
        win_ids[:, slot] = torch.where(ins, wj, win_ids[:, slot])
        bwc[:, slot] = torch.where(ins[:, None], rg.bwin[w_safe],
                                   bwc[:, slot])
        lwc[:, slot] = torch.where(ins[:, None], rg.lwin[w_safe],
                                   lwc[:, slot])

    pool = c["want_br"].reshape(n_prog, _BLK * N_WANTB)
    width = pool.shape[1]
    lanes = torch.arange(width, device=dev)
    keys = width - ((lanes[None, :] - rot
                     - 16 * torch.arange(N_BCACHE, device=dev)[:, None])
                    % width)
    remaining = pool >= 0
    picks = []
    for j in range(N_BCACHE):
        mx, pi = torch.where(remaining, keys[j], 0).max(dim=1)
        bj = torch.where(mx > 0, torch.gather(pool, 1, pi[:, None])[:, 0], -1)
        picks.append(bj)
        remaining = remaining & (pool != bj[:, None])
    new = torch.stack(picks, dim=1)
    rows = rg.brick_dir[torch.clamp(new, 0, rg.brick_dir.shape[0] - 1).long()]
    bid = torch.where((new >= 0) & (rows >= 0), new, -1).to(i32)
    cnt = rg.bricks[torch.clamp(rows, 0, rg.bricks.shape[0] - 1).long()]
    return win_ids, bwc, lwc, bid, cnt.reshape(n_prog, _CROWS, 128)


def _rounds(rg, f, c, rounds, sub_rounds):
    """Rounds of service and :func:`march2` from the frame inputs ``f``
    and carry ``c`` of :func:`_frame_inputs`; yields the carry after each
    round."""
    for r in range(rounds):
        win_ids, bwc, lwc, bid, cnt = _serve(rg, c, r)
        outs = march2(f["scal"], f["dx"], f["dy"], f["dz"], f["gj"], f["gl"],
                      win_ids, bwc, lwc, bid, cnt,
                      *(c["state"][k] for k in STATE),
                      sub_rounds=sub_rounds, nb=f["nb"],
                      bg_side=f["bg_side"])
        c = dict(state=dict(zip(STATE, outs[:10])), win_ids=win_ids, bwc=bwc,
                 lwc=lwc, want_win=outs[10], want_br=outs[11])
        yield c


def _trace_frame(rg, origin, dirs, *, width, height, rounds, sub_rounds):
    """The v2 round loop of one frame (wavefront2.py:_trace_frame :563):
    ``rounds`` rounds of service and :func:`march2`, then the finish."""
    f, c = _frame_inputs(rg, origin, dirs, width, height)
    for c in _rounds(rg, f, c, rounds, sub_rounds):
        pass
    return _finish2(rg, f, c["state"], width, height)


def _finish2(rg, f, s, width, height):
    """The :class:`WavefrontResult` (wavefront2.py:717-763): a ray that used
    up its budget without a hit is a miss; the water interval closes at
    ``min(t, t_exit)``."""
    f32 = torch.float32
    dx, dy, dz = f["dx"], f["dy"], f["dz"]
    iv = [_inv_dir(dx), _inv_dir(dy), _inv_dir(dz)]
    o = f["origin"]
    t_exit = _slab_exit(float(rg.size_voxels), *(o[k] for k in range(3)),
                        iv)
    t_stop = torch.minimum(s["t"], t_exit)
    water = s["water"] + torch.where(s["wenter"] >= 0.0,
                                     t_stop - s["wenter"], 0.0)
    ax = s["axmask"]
    norm = torch.stack([-torch.sign(d) * ((ax >> k) & 1).to(f32)
                        for k, d in enumerate((dx, dy, dz))], dim=-1)
    voxel = rg.to_pack[torch.clamp(s["vox"], 0, 255).long()]

    def untile(x):
        return _untile_rm(x, f["tx"], f["ty"], width, height)

    return WavefrontResult(hit=untile(s["hit"] != 0), voxel=untile(voxel),
                           norm=untile(norm), t=untile(t_stop),
                           water_dist=untile(water),
                           steps=untile(s["steps"]))


def trace_wavefront2(rg: RenderGrid, origin, dirs, *, width, height,
                     rounds=12, steps_per_round=48):
    """March one frame through a v1 :class:`RenderGrid` -> a
    :class:`WavefrontResult` in image order on the grid's device.

    ``origin`` f32[3] (world-local) and ``dirs`` f32[H,W,3], as
    ``generate_rays_raw`` makes them. ``steps_per_round`` is split into
    sub-rounds of 12 steps (at least one); ``rounds * steps_per_round``
    plays the role of the reference kernel's 500-step cap
    (ray_tracer.wgsl:220). Every round runs."""
    if width % TILE_W or height % TILE_H:
        raise ValueError(f"frame {width}x{height} is not whole 16x8 tiles")
    return _trace_frame(rg, origin, dirs, width=width, height=height,
                        rounds=int(rounds),
                        sub_rounds=max(int(steps_per_round) // SUB_STEPS, 1))
