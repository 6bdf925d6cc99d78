"""The plain march of the reference: rays through a voxel world held as raw
pack ids.

Written from the march's stated semantics, not from the program's code or
tables. A ray starts at ``t = EPS_T`` and classifies each step from its
position alone, at the coarsest cell that holds no solid voxel and one
liquidity: a super-cell of ``64 << gs`` voxels, a subwindow of 16, a brick
of 4, else the voxel itself, where a solid voxel is a hit. A step that
does not hit advances to the exit of its cell plus ``EPS_T``. The leg ends
on a hit, at the world's edge, at the slab exit (capped at ``4v + 16``) or
once ``step_cap`` steps are taken. Water is the length the ray spent in
liquid cells. The occupancy of each cell size is worked out here from the
ids, in plain PyTorch, on the device of the ids.

Every float operation runs in ``dtype``: float32, as the configurations
state, or a lower precision for the control.
"""

from typing import NamedTuple

import torch

EPS_T = 1e-3        # the step past a cell's exit
BIG = 1e9           # the exit along an axis the ray does not move on
BIG_IV = 0.99 * 1e7  # |1 / d| at which an axis counts as not moving
WINDOW = 64         # window edge (voxels); subwindows are 16, bricks 4
EMPTY, LIQUID, SOLID = 0, 1, 2


def super_shift(n_windows):
    """The smallest shift ``gs`` with ``ceil(n_windows / 2**gs) <= 16``: the
    march's largest cell is ``WINDOW << gs`` voxels."""
    gs = 0
    while -(-n_windows // (1 << gs)) > 16:
        gs += 1
    return gs


class Scene(NamedTuple):
    """A voxel world for the reference: ``ids`` uint8 [Vp, Vp, Vp] pack ids
    (x, y, z), ``cls`` their class (EMPTY, LIQUID or SOLID), the world's
    edge ``v`` in voxels (ids past it are air), and per cell size, coarsest
    first, ``(edge, code)`` with ``code`` uint8 [n, n, n]: bit 0 a cell the
    march crosses in one step (no solid voxel, one liquidity), bit 1 such a
    cell all liquid."""

    ids: torch.Tensor
    cls: torch.Tensor
    v: int
    levels: tuple


def _reduce(m, f, op):
    """``op`` over each f x f x f block of a cubic uint8 grid."""
    n = m.shape[0] // f
    return op(m.reshape(n, f, n, f, n, f), dim=(1, 3, 5))


def _code(any_s, all_l, any_l):
    jump = (1 - any_s) & (all_l | (1 - any_l))
    return jump | ((jump & all_l) << 1)


def make_scene(ids, is_liquid, v):
    """The reference's scene of a world: ``ids`` uint8 [Vp, Vp, Vp] pack ids
    (x, y, z; Vp a multiple of 64, air past ``v``), ``is_liquid`` bool per
    pack id. Pack id 0 is air; every other id that is not liquid is solid."""
    dev = ids.device
    cls_of = torch.full((256,), SOLID, dtype=torch.uint8, device=dev)
    liq = torch.as_tensor(is_liquid, dtype=torch.bool, device=dev)
    cls_of[:len(liq)][liq] = LIQUID
    cls_of[0] = EMPTY
    cls = torch.empty_like(ids)
    for x0 in range(0, ids.shape[0], 64):    # slabs: an int64 copy of all ids is 8 bytes a voxel
        cls[x0:x0 + 64] = cls_of[ids[x0:x0 + 64].long()]
    any_s = (cls == SOLID).to(torch.uint8)
    all_l = (cls == LIQUID).to(torch.uint8)
    any_l = all_l
    codes = []
    for edge in (4, 16, 64):     # bricks, subwindows, windows: 4 x 4 x 4 each
        any_s = _reduce(any_s, 4, torch.amax)
        all_l = _reduce(all_l, 4, torch.amin)
        any_l = _reduce(any_l, 4, torch.amax)
        codes.append((edge, _code(any_s, all_l, any_l)))
    nw = ids.shape[0] // WINDOW
    gs = super_shift(nw)
    win = codes[2][1]
    if gs:
        # a super-cell is crossed in one step when each of its windows is,
        # with one liquidity among them; windows past the world count as
        # empty
        g = 1 << gs
        pad = -(-nw // g) * g - nw
        jump = torch.nn.functional.pad(win & 1, (0, pad) * 3, value=1)
        wl = torch.nn.functional.pad(win >> 1, (0, pad) * 3, value=0)
        wl_all = torch.nn.functional.pad(win >> 1, (0, pad) * 3, value=1)
        sup = _code(1 - _reduce(jump, g, torch.amin),
                    _reduce(wl_all, g, torch.amin), _reduce(wl, g, torch.amax))
        codes[2] = (WINDOW << gs, sup)
    return Scene(ids, cls, int(v), tuple(reversed(codes)))


class Leg(NamedTuple):
    """What one leg of each ray found: ``t`` where it stopped (at most
    ``t_exit``), ``hit``, the axes of the face it crossed last (bits x, y,
    z), the water length, the steps taken, the pack id hit (0 on a miss),
    and the work: steps and rays marched, and the distinct subwindows and
    windows whose voxels or bricks a step looked at."""

    t: torch.Tensor
    t_exit: torch.Tensor
    hit: torch.Tensor
    axm: torch.Tensor
    water: torch.Tensor
    steps: torch.Tensor
    vox: torch.Tensor
    n_steps: int
    n_rays: int
    rows: int
    windows: int


def inverse(d):
    """1 / d with d held at least 1e-7 away from 0 (its sign kept; 0 counts
    as positive)."""
    return 1.0 / torch.where(d >= 0, torch.clamp_min(d, 1e-7),
                             torch.clamp_max(d, -1e-7))


def slab_exit(v, o, iv):
    """Where each ray leaves the slab [0, v)^3, capped at 4v + 16."""
    ex = [torch.maximum((0.0 - oc) * ivc, (v - oc) * ivc) for oc, ivc in zip(o, iv)]
    return torch.clamp_max(torch.minimum(ex[0], torch.minimum(ex[1], ex[2])),
                           4.0 * v + 16.0)


def march(scene, o, d, active, step_cap):
    """One leg of every ray from ``t = EPS_T``. ``o``, ``d``: three flat
    tensors each (origins and unit directions) of one float dtype, which
    the whole march computes in; ``active``: bool, the rays that march."""
    dt_ = d[0].dtype
    dev = d[0].device
    n = d[0].numel()
    v = float(scene.v)
    vp = scene.ids.shape[0]
    iv = [inverse(c) for c in d]
    sgn = [torch.where(c > 0, 1.0, -1.0).to(dt_) for c in d]
    ivs = [a * s for a, s in zip(iv, sgn)]
    flat = [a.abs() >= BIG_IV for a in iv]
    t_exit = slab_exit(v, o, iv)

    t = torch.full((n,), EPS_T, dtype=dt_, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    axm = torch.zeros(n, dtype=torch.int32, device=dev)
    water = torch.zeros(n, dtype=dt_, device=dev)
    wenter = torch.full((n,), -1.0, dtype=dt_, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    full = (t, hit, axm, water, wenter, steps)
    # one slot past the end takes the marks of steps that mark nothing
    ns, nw = vp // 16, vp // 64
    rows_seen = torch.zeros(ns ** 3 + 1, dtype=torch.bool, device=dev)
    wins_seen = torch.zeros(nw ** 3 + 1, dtype=torch.bool, device=dev)

    idx = torch.nonzero(active).squeeze(1)
    n_rays = int(idx.numel())
    n_steps = 0
    per_ray = [x[idx] for x in (*o, *d, *sgn, *ivs, *flat, t_exit)]
    state = [x[idx] for x in full]
    (sup_edge, sup), (_, subw), (_, brick) = scene.levels
    ids_flat, cls_flat = scene.ids.reshape(-1), scene.cls.reshape(-1)

    def code(grid, edge, q):
        m = grid.shape[0]
        return grid.reshape(-1)[((q[0] // edge) * m + q[1] // edge) * m + q[2] // edge]

    while idx.numel():
        ox, oy, oz, dx, dy, dz = per_ray[:6]
        ct, chit, caxm, cwat, cwen, cstp = state
        p = [ox + dx * ct, oy + dy * ct, oz + dz * ct]
        go = ~chit & (ct < per_ray[15]) & (cstp < step_cap)
        for pc in p:
            go = go & (pc >= 0) & (pc < v)
        if not bool(go.all()):
            stop = ~go
            sel = idx[stop]
            for f, part in zip(full, state):
                f[sel] = part[stop]
            keep = torch.nonzero(go).squeeze(1)
            idx = idx[keep]
            if not idx.numel():
                break
            per_ray = [x[keep] for x in per_ray]
            state = [x[keep] for x in state]
            p = [pc[keep] for pc in p]
            ct, chit, caxm, cwat, cwen, cstp = state
        sx, sy, sz, ix, iy, iz, fx, fy, fz = per_ray[6:15]
        n_steps += int(idx.numel())
        q = [torch.floor(pc).long() for pc in p]
        c_sup = code(sup, sup_edge, q)
        c_sub = code(subw, 16, q)
        c_brk = code(brick, 4, q)
        vcls = cls_flat[(q[0] * vp + q[1]) * vp + q[2]]
        in_sup = (c_sup & 1) == 1
        in_sub = ~in_sup & ((c_sub & 1) == 1)
        in_brk = ~in_sup & ~in_sub & ((c_brk & 1) == 1)
        at_vox = ~in_sup & ~in_sub & ~in_brk
        hit_now = at_vox & (vcls == SOLID)
        liquid = torch.where(in_sup, c_sup >> 1, torch.where(
            in_sub, c_sub >> 1, torch.where(in_brk, c_brk >> 1,
                                            (vcls == LIQUID).to(torch.uint8)))) == 1
        cell = torch.where(in_sup, float(sup_edge), torch.where(
            in_sub, 16.0, torch.where(in_brk, 4.0, 1.0))).to(dt_)
        # the work: subwindows whose bricks or voxels a step reads, windows
        # whose subwindows it reads
        deep = ~in_sup & ~in_sub
        rows_seen[torch.where(deep, ((q[0] // 16) * ns + q[1] // 16) * ns
                              + q[2] // 16, ns ** 3)] = True
        wins_seen[torch.where(~in_sup, ((q[0] // 64) * nw + q[1] // 64) * nw
                              + q[2] // 64, nw ** 3)] = True

        # water: close the open interval on leaving liquid, open one on
        # marching into it
        leave = (cwen >= 0) & ~liquid
        cwat = torch.where(leave, cwat + (ct - cwen), cwat)
        cwen = torch.where(leave, -1.0, cwen).to(dt_)
        moving = ~hit_now
        cwen = torch.where(moving & liquid & (cwen < 0), ct, cwen)

        def exit_along(pc, s, ivc, fl):
            ps = pc * s
            return torch.where(fl, BIG, ((torch.floor(ps / cell) + 1.0) * cell - ps) * ivc)

        ex = exit_along(p[0], sx, ix, fx)
        ey = exit_along(p[1], sy, iy, fy)
        ez = exit_along(p[2], sz, iz, fz)
        dmin = torch.minimum(ex, torch.minimum(ey, ez))
        crossed = ((ex <= dmin).int() | ((ey <= dmin).int() << 1)
                   | ((ez <= dmin).int() << 2))
        state = [torch.where(moving, ct + dmin + EPS_T, ct).to(dt_), hit_now,
                 torch.where(moving, crossed, caxm), cwat, cwen, cstp + 1]

    t = torch.minimum(t, t_exit)
    water = water + torch.where(wenter >= 0, t - wenter, 0.0).to(dt_)
    vox = torch.zeros(n, dtype=torch.int32, device=dev)
    hi = torch.nonzero(hit).squeeze(1)
    if hi.numel():
        q = [torch.floor(oc[hi] + dc[hi] * t[hi]).long() for oc, dc in zip(o, d)]
        vox[hi] = ids_flat[(q[0] * vp + q[1]) * vp + q[2]].int()
    return Leg(t, t_exit, hit, axm, water, steps, vox, n_steps, n_rays,
               int(rows_seen[:-1].sum()), int(wins_seen[:-1].sum()))
