"""The port's v3 round loop against the JAX package on the CPU: warm
tokens (the port's, JAX's legacy 2-tuple, ``empty_frame_cache``) and the
tokens themselves, per-ray bundles (``trace_wavefront3_rays``), the
lookahead want-list, and the ``"gather"`` hit-id route of a grid with
overflowed palettes.

Unlike the v4 token, the v3 token steers the service: it decides which
rays finish within a starved budget, so warm frames are compared at
``rounds=4``. JAX runs its Pallas kernel in interpret mode; each golden
is computed once, in a module fixture. Scene, cameras and tolerances:
tests/torch_v3_scene.py.
"""

import numpy as np
import pytest
import torch

from test_torch_palettes import CAM as NOISE_CAM
from test_torch_palettes import _noise_world
from torch_v3_scene import (
    CAMS,
    SIZE,
    SUN,
    assert_result,
    assert_token,
    scene,
)
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)
from voxelraytracing_tpu.ops import wavefront3 as j3
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.ops.camera import generate_rays as j_generate_rays
from voxelraytracing_tpu_torch.convert import render_grid3_from_numpy
from voxelraytracing_tpu_torch.ops import wavefront3 as t3
from voxelraytracing_tpu_torch.ops.camera import CamData

ROUNDS = 4
BUNDLE_ROUNDS = (2, 16)


def _jcam(i, size=SIZE):
    cam = JCamData.create(*CAMS[i], 70.0, size)
    return cam, j_generate_rays(cam, np.zeros(3, np.int32))[0]


def _tcam(i, size=SIZE):
    cam = CamData.create(*CAMS[i], 70.0, size)
    return cam, np.asarray(cam.pos, np.float32)


def _bundle(res):
    """Shadow-like bundle from a primary result (image order): hit points
    nudged along the normal, aimed at the sun, active where hit."""
    hit = np.asarray(res.hit)
    cam, origin = _jcam(0)
    _, dirs = j_generate_rays(cam, np.zeros(3, np.int32))
    dirs = np.asarray(dirs, np.float32)
    p = (np.asarray(origin, np.float32) + dirs * np.asarray(res.t)[..., None]
         + np.asarray(res.norm, np.float32) * np.float32(1e-3))
    d = np.asarray(SUN, np.float32) - p
    d = d / np.sqrt((d * d).sum(-1, keepdims=True))
    return p.astype(np.float32), d.astype(np.float32), hit


@pytest.fixture(scope="module")
def world():
    """JAX goldens: a chain of warm frames over the four cameras (each
    warm from the previous frame's token), the same frames from JAX's
    legacy 2-tuple and from ``empty_frame_cache``, a bundle at two
    budgets, ``lookahead=2`` on every camera, and the gather route of
    the overflowed noise world."""
    jrg, trg, _ = scene()
    gold = {}
    tok = None
    for i in range(len(CAMS)):
        cam, origin = _jcam(i)
        kw = dict(cam=cam, rounds=ROUNDS, step_cap=500, return_cache=True)
        gold["chain", i] = j3.trace_wavefront3(jrg, origin, cache=tok, **kw)
        if tok is not None:
            gold["legacy", i] = j3.trace_wavefront3(
                jrg, origin, cache=tok[:2], cam=cam, rounds=ROUNDS,
                step_cap=500)
        tok = gold["chain", i][1]
        gold["empty", i] = j3.trace_wavefront3(
            jrg, origin, cache=j3.empty_frame_cache(*SIZE), **kw)
        gold["look", i] = j3.trace_wavefront3(
            jrg, origin, cam=cam, rounds=ROUNDS, step_cap=500, lookahead=2)
    gold["bundle"] = _bundle(gold["chain", 0][0])
    for r in BUNDLE_ROUNDS:
        gold["rays", r] = j3.trace_wavefront3_rays(
            jrg, *gold["bundle"], width=SIZE[0], height=SIZE[1], rounds=r)
    njrg, _ = _noise_world()
    cam = JCamData.create(NOISE_CAM[0], NOISE_CAM[1], 70.0, SIZE)
    norigin, _ = j_generate_rays(cam, np.zeros(3, np.int32))
    gold["gather"] = j3.trace_wavefront3(njrg, norigin, cam=cam, rounds=16,
                                         step_cap=500)
    ntrg = render_grid3_from_numpy(
        *[np.asarray(getattr(njrg, f)) for f in t3.RenderGrid3._fields],
        device="cpu")
    return trg, ntrg, gold


def test_warm_chain_matches_jax(world):
    """Four frames, each warm from the last one's token: results and
    tokens (cache ids and service history) word for word."""
    trg, _, gold = world
    tok = None
    for i in range(len(CAMS)):
        cam, origin = _tcam(i)
        res, tok = t3.trace_wavefront3(trg, origin, cam=cam, rounds=ROUNDS,
                                       step_cap=500, cache=tok,
                                       return_cache=True)
        assert_result(res, gold["chain", i][0])
        assert_token(tok, gold["chain", i][1])
        assert tok[0].shape == (1, t3.N_WC) and tok[2].shape == (16, 1, 8)


def test_token_steers_the_service(world):
    """A warm frame differs from the cold one at a starved budget (the
    token is not inert): in JAX, frame 2 of the chain hits other pixels
    than the same camera's cold frame, and the port's does too."""
    trg, _, gold = world
    warm = np.asarray(gold["chain", 2][0].hit)
    cold = np.asarray(gold["empty", 2][0].hit)
    assert (warm != cold).sum() > 20
    cam, origin = _tcam(2)
    res = t3.trace_wavefront3(trg, origin, cam=cam, rounds=ROUNDS,
                              step_cap=500, cache=_port_chain_token(trg, 2))
    np.testing.assert_array_equal(res.hit.numpy(), warm)


@pytest.mark.parametrize("cam", range(1, len(CAMS)))
def test_legacy_two_tuple_token_matches_jax(world, cam):
    """JAX's legacy token (ids, no history) warm-starts the ids and leaves
    the history replay empty."""
    trg, _, gold = world
    c, origin = _tcam(cam)
    tok = t3.trace_wavefront3(trg, _tcam(cam - 1)[1], cam=_tcam(cam - 1)[0],
                              rounds=ROUNDS, step_cap=500,
                              cache=_port_chain_token(trg, cam - 1),
                              return_cache=True)[1]
    res = t3.trace_wavefront3(trg, origin, cam=c, rounds=ROUNDS,
                              step_cap=500, cache=tok[:2])
    assert_result(res, gold["legacy", cam])


def _port_chain_token(trg, upto):
    """The port's token entering frame ``upto`` of the warm chain."""
    tok = None
    for i in range(upto):
        cam, origin = _tcam(i)
        tok = t3.trace_wavefront3(trg, origin, cam=cam, rounds=ROUNDS,
                                  step_cap=500, cache=tok,
                                  return_cache=True)[1]
    return tok


@pytest.mark.parametrize("cam", range(len(CAMS)))
def test_empty_frame_cache_matches_jax_and_cold(world, cam):
    trg, _, gold = world
    c, origin = _tcam(cam)
    empty = t3.empty_frame_cache(*SIZE, device="cpu")
    assert_token(empty, j3.empty_frame_cache(*SIZE))
    res, tok = t3.trace_wavefront3(trg, origin, cam=c, rounds=ROUNDS,
                                   step_cap=500, cache=empty,
                                   return_cache=True)
    assert_result(res, gold["empty", cam][0])
    assert_token(tok, gold["empty", cam][1])
    cold, cold_tok = t3.trace_wavefront3(trg, origin, cam=c, rounds=ROUNDS,
                                         step_cap=500, return_cache=True)
    assert_result(cold, gold["empty", cam][0])
    assert_token(cold_tok, tok)


@pytest.mark.parametrize("cam", range(len(CAMS)))
def test_lookahead_matches_jax(world, cam):
    """``lookahead=2``: the prefetch want columns feed the service's third
    class."""
    trg, _, gold = world
    c, origin = _tcam(cam)
    res = t3.trace_wavefront3(trg, origin, cam=c, rounds=ROUNDS,
                              step_cap=500, lookahead=2)
    assert_result(res, gold["look", cam])


@pytest.mark.parametrize("rounds", BUNDLE_ROUNDS)
def test_trace_wavefront3_rays_matches_jax(world, rounds):
    trg, _, gold = world
    o, d, a = gold["bundle"]
    res = t3.trace_wavefront3_rays(
        trg, torch.tensor(o), torch.tensor(d), torch.tensor(a),
        width=SIZE[0], height=SIZE[1], rounds=rounds)
    assert_result(res, gold["rays", rounds])
    if rounds == max(BUNDLE_ROUNDS):
        assert res.hit.any() and not res.hit.all()


def test_gather_route_matches_jax(world):
    """A ``palettes_ok=False`` grid resolves hit ids through the v1 brick
    tables by default (wavefront3.py:1790-1791, :1682-1706): every id
    exact, unlike the palette decode."""
    _, ntrg, gold = world
    assert not ntrg.palettes_ok
    cam = CamData.create(NOISE_CAM[0], NOISE_CAM[1], 70.0, SIZE)
    res = t3.trace_wavefront3(ntrg, np.asarray(cam.pos, np.float32), cam=cam,
                              rounds=16, step_cap=500)
    assert_result(res, gold["gather"])
    pal = t3.trace_wavefront3(ntrg, np.asarray(cam.pos, np.float32), cam=cam,
                              rounds=16, step_cap=500, resolve_ids="palette")
    hit = res.hit.numpy()
    assert (res.voxel.numpy() != pal.voxel.numpy())[hit].any()
