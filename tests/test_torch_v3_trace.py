"""The port's v3 march (``march3_ref``, the plain version of
``csrc/march3.cu``) and ``trace_wavefront3`` against the JAX package on
the CPU, at starved and converged round budgets.

JAX runs its Pallas kernel in interpret mode, as its own tests do; each
golden is computed once, in a module fixture (``rounds`` is traced in
JAX, so the budgets share one compile). Scene, cameras and tolerances:
tests/torch_v3_scene.py.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from torch_v3_scene import (
    CAMS,
    SIZE,
    SUN,
    T_RTOL,
    W_ATOL,
    assert_result,
    scene,
)
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)
from voxelraytracing_tpu.ops import wavefront3 as j3
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.ops.camera import generate_rays as j_generate_rays
from voxelraytracing_tpu_torch.ops import wavefront3 as t3
from voxelraytracing_tpu_torch.ops.camera import CamData

ROUNDS = (1, 2, 4, 32)
CAPS = (4, 500)
_FL_BIAS = 0x30000000  # JAX's flags-in-f32 bias


@pytest.fixture(scope="module")
def world():
    """The scene and JAX's trace of every (camera, rounds, cap)."""
    jrg, trg, mats = scene()
    gold = {}
    for i, (rot, eye) in enumerate(CAMS):
        cam = JCamData.create(rot, eye, 70.0, SIZE)
        origin, _ = j_generate_rays(cam, np.zeros(3, np.int32))
        for rounds in ROUNDS:
            for cap in CAPS:
                gold[i, rounds, cap] = j3.trace_wavefront3(
                    jrg, origin, cam=cam, rounds=rounds, step_cap=cap)
    return jrg, trg, mats, gold


def _port_trace(trg, i, **kw):
    cam = CamData.create(*CAMS[i], 70.0, SIZE)
    return t3.trace_wavefront3(trg, np.asarray(cam.pos, np.float32),
                               cam=cam, **kw)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("rounds", ROUNDS)
@pytest.mark.parametrize("cam", range(len(CAMS)))
def test_trace_wavefront3_matches_jax(world, cam, rounds, cap):
    _, trg, _, gold = world
    assert_result(_port_trace(trg, cam, rounds=rounds, step_cap=cap),
                  gold[cam, rounds, cap])


def test_round_budget_decides_the_frame(world):
    """What the budgets pin: a starved budget turns rays into sky
    (tests/test_wavefront3.py:318-338), so the v3 frame is not the
    converged v4 frame below convergence."""
    _, _, _, gold = world
    hits = [int(np.asarray(gold[0, r, 500].hit).sum()) for r in ROUNDS]
    assert hits == sorted(hits) and hits[0] < hits[-1], hits
    assert hits[ROUNDS.index(4)] < hits[-1]


def _jax_march(static, scal, mc, ts, fl, wa, we, rays=None):
    """One launch of JAX's ``_march`` on the port's inputs (flags biased
    into the f32 state as JAX carries them)."""
    st = np.stack([ts, (fl + _FL_BIAS).view(np.float32), wa, we])
    kw = {} if rays is None else dict(rays=rays)
    st2, want = static(scal, mc.view(np.uint32), st, **kw)
    st2 = np.asarray(st2)
    return (st2[0], st2[1].view(np.int32) - _FL_BIAS, st2[2], st2[3],
            np.asarray(want))


# JAX's jitted _march of each static launch shape, shared by both cases
# of the test below (both run camera-ray launches of 6 and 30 sub-rounds)
_JITTED = {}


def _jitted_march(kw):
    key = tuple(kw[k] for k in ("sub_rounds", "nw", "ns", "nsx", "lookahead"))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(functools.partial(
            j3._march, sub_rounds=kw["sub_rounds"], sub_steps=8,
            nw=kw["nw"], ns=kw["ns"], nsx=kw["nsx"], interpret=True,
            lookahead=kw["lookahead"]))
    return _JITTED[key]


@pytest.mark.parametrize("per_ray", [False, True], ids=["camera", "bundle"])
def test_march3_ref_matches_jax_launch_by_launch(world, per_ray):
    """Every launch of a frame: the port's round loop serves the wants and
    feeds the same scalar row, cache block and state to ``march3_ref``
    and to JAX's ``_march``; states, flags and wants agree (``t`` and
    water within the FMA bar). Camera rays (round-0 init in the kernel)
    and a shadow bundle (per-ray mode)."""
    _, trg, mats, _ = world
    seen = []
    ref = t3.march3_ref

    def both(scal, mc, ts, fl, wa, we, rays=None, tile_map=None, **kw):
        out, want = ref(scal, mc, ts, fl, wa, we, rays, tile_map, **kw)
        got = _jax_march(_jitted_march(kw), scal.numpy(), mc.numpy(),
                         ts.numpy(), fl.numpy(), wa.numpy(), we.numpy(),
                         None if rays is None else rays.numpy())
        np.testing.assert_array_equal(out[1].numpy(), got[1])
        np.testing.assert_array_equal(want.numpy(), got[4])
        np.testing.assert_allclose(out[0].numpy(), got[0], rtol=T_RTOL)
        for a, b in ((out[2], got[2]), (out[3], got[3])):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=W_ATOL)
        seen.append(rays is not None)
        return out, want

    cam = CamData.create(*CAMS[0], 70.0, SIZE)
    t3.march3_ref = both
    try:
        if per_ray:
            t3.render_frame3(trg, cam, mats.color, sun_pos=SUN, shadows=True,
                             rounds=8, step_cap=500)
        else:
            t3.trace_wavefront3(trg, np.asarray(cam.pos, np.float32),
                                cam=cam, rounds=8, step_cap=500)
    finally:
        t3.march3_ref = ref
    assert any(s == per_ray for s in seen) and len(seen) >= 8, seen


def test_march3_ref_passes_idle_programs_through():
    """A program with no active ray returns its input state unchanged and
    wants nothing (wavefront3.py:988-993)."""
    g = torch.Generator().manual_seed(0)
    T = 64
    ts = torch.rand((T, 128), generator=g)
    fl = (torch.randint(0, 1 << 20, (T, 128), generator=g,
                        dtype=torch.int32) << 1)       # active bit clear
    wa, we = torch.rand((T, 128), generator=g), torch.rand((T, 128), generator=g)
    mc = torch.zeros((1, t3.MC_ROWS, 128), dtype=torch.int32)
    scal = torch.zeros(27)
    scal[3], scal[22], scal[23] = 128.0, 6.0, 500.0
    out, want = t3.march3_ref(scal, mc, ts, fl, wa, we, nw=2, ns=8, nsx=1,
                              sub_rounds=6)
    for a, b in zip(out, (ts, fl, wa, we)):
        assert torch.equal(a, b)
    assert bool((want == -1).all())
