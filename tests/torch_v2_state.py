"""A hand-made round of the v2 march that tells a program-wide ``go`` from
a per-tile one (tests/test_torch_v2.py holds the plain version to JAX on
it, tests/test_torch_kernels.py the kernel to the plain version).

One program of 256 tiles, every ray inactive but two:
  * tile 0, lane 0 ("stranded"): a voxel-level ray whose position has left
    its ``cur_brick``, a brick that the program's cache does not hold. It
    cannot march, and its tile has no other ray;
  * tile 3, lane 7 ("stepper"): a brick-level ray in the camera's window,
    which slot 0 of the window cache holds, so it can march.
The JAX kernel runs the program's sub-rounds because the stepper can
march, and every ray of the program takes the steps: the stranded ray is
demoted to brick level at its first step (wavefront2.py:298). A per-tile
``go`` would leave it at voxel level. ``go_probe2`` lays two such
programs side by side: the first with its stepper moved to tile 40, in
another block of the program's cluster than the stranded ray's tile 0
(csrc/march2.cu), the second with no stepper, so its ``go`` is false.
Imports only the port and NumPy.
"""

import numpy as np
import torch

from voxelraytracing_tpu_torch.ops import wavefront2 as t2

ORIGIN = (64.0, 75.0, 64.0)  # tests/torch_v3_scene.py CAMS[0]'s eye
STRANDED = (0, 0)
STEPPER = (3, 7)


def go_probe(rg, device):
    """``(args, kw)`` of one :func:`~wavefront2.march2` call on the v1 grid
    ``rg`` (on ``device``); the rays' directions are seeded."""
    f32, i32 = np.float32, np.int32
    T = t2._BLK
    nb = t2._world_nb(rg)
    bg_side = nb * t2.BWIN
    rng = np.random.default_rng(6)
    d = rng.normal(size=(T, 128, 3)).astype(f32)
    d /= np.sqrt((d * d).sum(axis=-1, keepdims=True)).astype(f32)
    o = np.asarray(ORIGIN, f32)
    b = np.floor(o * f32(0.25)).astype(np.int64)
    fb = int(b[0] + b[1] * bg_side + b[2] * bg_side * bg_side)
    w = (b >> 4)
    wflat = int(w[0] + w[1] * nb + w[2] * nb * nb)

    state = {k: np.zeros((T, 128), f32 if k in t2._FLOAT_PLANES else i32)
             for k in t2.STATE}
    state["t"][:] = f32(1e-3)
    state["wenter"][:] = -1.0
    state["cur_brick"][:] = -1
    state["active"][STRANDED] = 1
    state["level"][STRANDED] = 1
    state["cur_brick"][STRANDED] = fb + 1
    state["active"][STEPPER] = 1

    gj, gl = t2._global_planes(rg.bwin, rg.lwin)
    wid = np.full((1, t2.N_WCACHE), -1, i32)
    wid[0, 0] = wflat
    bwc = torch.zeros((1, t2.N_WCACHE, 128), dtype=torch.int32, device=device)
    lwc = torch.zeros_like(bwc)
    bwc[0, 0] = rg.bwin[wflat]
    lwc[0, 0] = rg.lwin[wflat]

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    scal = np.zeros(t2.N_SCAL2, f32)
    scal[:3] = o
    scal[3] = rg.n_liquid
    scal[4] = rg.size_voxels
    args = ([dev(scal)] + [dev(d[..., k]) for k in range(3)]
            + [gj, gl, dev(wid), bwc, lwc,
               dev(np.full((1, t2.N_BCACHE), -1, i32)),
               torch.zeros((1, t2._CROWS, 128), dtype=torch.int32,
                           device=device)]
            + [dev(state[k]) for k in t2.STATE])
    return args, dict(sub_rounds=2, nb=nb, bg_side=bg_side)


def go_probe2(rg, device):
    """``(args, kw)`` of one :func:`~wavefront2.march2` call of two
    programs (see the module's docstring)."""
    args, kw = go_probe(rg, device)
    planes = [torch.cat([x, x]) for x in args[1:4] + args[11:]]
    per_prog = [torch.cat([x, x]) for x in args[6:11]]
    active = planes[3 + 1]
    active[STEPPER] = 0
    active[40, STEPPER[1]] = 1
    active[t2._BLK + STEPPER[0], STEPPER[1]] = 0
    return [args[0]] + planes[:3] + args[4:6] + per_prog + planes[3:], kw
