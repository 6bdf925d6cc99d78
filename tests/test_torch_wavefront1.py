"""The port's v1 tracer (``ops/wavefront.py:trace_wavefront``) against the
JAX package's on the CPU, against the port's own SVO tracer, and
``WavefrontRenderer.render`` on a v1 grid for the tracers that reach it.

The scene, cameras and sizes are tests/test_wavefront.py's: the 4-chunk
demo world (noise seed 7), built by both packages' host builders (equal
to the device ones word for word, test_wavefront.py:99-125), its four
CAMS at 64x32, the camera outside the world and the heatmap frame at
32x16. JAX's rays are made op by op (``jax.disable_jit()``), as in
tests/test_torch_v2.py.

XLA's CPU compiler contracts ``o + d*t`` into an FMA inside JAX's jitted
programs, so the port is held to JAX's tracer evaluated op by op, where
every product is equal word for word: hits, ids, normals, steps, ``t``
and water. Under ``jax.disable_jit()`` JAX dispatches each primitive of
its tracer alone, which at the full budget takes tens of seconds a
camera; the capped budget runs so. The full-budget frames evaluate the
same JAX programs one primitive at a time in NumPy
(``jax_op_by_op.numpy_op_by_op``), a few seconds a camera, and the
capped budget holds that evaluator to ``jax.disable_jit()`` word for
word. Both JAX goldens end the round loop
once no ray is active (``check_every=1``), which changes no product.

``render`` runs JAX's renderer as it is (its tracer jitted), so its trace
is held to the v2 bars of tests/torch_v3_scene.py (measured on these
cases at most 6.2e-7 relative on ``t`` and 1.9e-5 on water) and the
image to ``IMG_ATOL`` (measured 8.9e-7), as tests/test_torch_v2.py holds
the v2 path; hits, ids, normals and steps equal.
"""

import jax
import numpy as np
import pytest
import torch

from jax_op_by_op import numpy_op_by_op
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)
from torch_v3_scene import CAMS, SIZE, SUN, T_RTOL, W_ATOL
import voxelraytracing_tpu.models.raytracer as j_rt
from voxelraytracing_tpu.ops import noise as j_noise
from voxelraytracing_tpu.ops import wavefront as j1
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.ops.camera import generate_rays as j_generate_rays
from voxelraytracing_tpu.world.demo import demo_chunk_grids_host, demo_materials
from voxelraytracing_tpu_torch.models import raytracer as t_rt
from voxelraytracing_tpu_torch.ops import wavefront as t1
from voxelraytracing_tpu_torch.ops.camera import CamData, generate_rays
from voxelraytracing_tpu_torch.ops.svo_build import build_chunk_svo_batch
from voxelraytracing_tpu_torch.ops.traverse import trace_rays
from voxelraytracing_tpu_torch.world.assemble import assemble_world_slice

IMG_ATOL = 4e-6
OUTSIDE = ((30.0, 45.0, 0.0), (-50.0, 75.0, 64.0))
SMALL = (32, 16)  # test_wavefront.py's size for the outside and heatmap frames
CAPPED = 4  # rounds: rays still march after them
# JAX's micro-programs of the v1 tracer (wavefront.py:351-696)
PROGRAMS = ("_prep_dirs", "_prep_inv", "_prep_sign", "_prep_texit",
            "_prep_carry", "_refetch", "_rows_win", "_rows_slots", "_pre",
            "_gather3", "_post_brick", "_post_voxel", "_n_active", "_finish")
NP_PROGRAMS = {name: numpy_op_by_op(getattr(j1, name)) for name in PROGRAMS}


def _jax_rays(cam, size):
    with jax.disable_jit():
        return j_generate_rays(JCamData.create(*cam, 70.0, size),
                               np.zeros(3, np.int32))


def _port_rays(cam, size):
    """The port's rays, equal to ``_jax_rays`` word for word
    (tests/test_torch_camera.py), made without JAX's per-shape compiles."""
    return generate_rays(CamData.create(*cam, 70.0, size),
                         np.zeros(3, np.int32), device="cpu")


def _jax_numpy_trace(jrg, rays, size, max_rounds):
    """JAX's ``trace_wavefront`` with each of its programs evaluated one
    primitive at a time in NumPy."""
    saved = {name: getattr(j1, name) for name in PROGRAMS}
    try:
        for name in PROGRAMS:
            setattr(j1, name, NP_PROGRAMS[name])
        return j1.trace_wavefront(jrg, *rays, width=size[0], height=size[1],
                                  max_rounds=max_rounds, check_every=1)
    finally:
        for name, f in saved.items():
            setattr(j1, name, f)


def _port_trace(trg, rays, size, max_rounds):
    o, d = (torch.tensor(np.asarray(x)) for x in rays)
    return t1.trace_wavefront(trg, o, d, width=size[0], height=size[1],
                              max_rounds=max_rounds)


def _assert_same(got, want):
    """Every product word for word."""
    for f in t1.WavefrontResult._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


@pytest.fixture(scope="module")
def world():
    """Both packages' v1 grids of the demo world, and JAX's rays of each
    camera at 64x32."""
    w = 4
    grids, cells = demo_chunk_grids_host(
        j_noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    mats = demo_materials()
    wmin = np.zeros(3, np.int32)
    jrg = j1.build_render_grid_host(grids, cells, wmin, w, mats)
    trg = t1.build_render_grid_host(grids, cells, wmin, w, mats,
                                    device="cpu")
    rays = [_jax_rays(cam, SIZE) for cam in CAMS]
    return jrg, trg, mats, grids, cells, rays


@pytest.fixture(scope="module")
def traces(world):
    """The port's and JAX's (NumPy op by op) traces of the four cameras
    at 64x32 and 64 rounds."""
    jrg, trg, _, _, _, rays = world
    return [(_port_trace(trg, r, SIZE, 64), _jax_numpy_trace(jrg, r, SIZE, 64))
            for r in rays]


@pytest.mark.parametrize("i", range(len(CAMS)))
def test_trace_matches_jax(traces, i):
    got, want = traces[i]
    _assert_same(got, want)
    assert bool(got.hit.any())


def test_capped_budget_matches_jax_without_jit(world, traces):
    """A budget of 4 rounds stops rays mid-march, so the frame depends on
    the refetch's rotation order and slot gating round by round: the port
    equals JAX's tracer under ``jax.disable_jit()``, and so does JAX's
    tracer evaluated in NumPy (the golden of the full-budget tests)."""
    jrg, trg, _, _, _, rays = world
    with jax.disable_jit():
        want = j1.trace_wavefront(jrg, *rays[0], width=SIZE[0],
                                  height=SIZE[1], max_rounds=CAPPED)
    got = _port_trace(trg, rays[0], SIZE, CAPPED)
    _assert_same(got, want)
    for f, a in zip(t1.WavefrontResult._fields,
                    _jax_numpy_trace(jrg, rays[0], SIZE, CAPPED)):
        np.testing.assert_array_equal(a, np.asarray(getattr(want, f)), f)
    # the cap left rays short of their hit: fewer hits than the full budget
    assert int(got.hit.sum()) < int(traces[0][0].hit.sum())


def test_camera_outside_world_sees_nothing(world):
    jrg, trg, _, _, _, _ = world
    rays = _port_rays(OUTSIDE, SMALL)
    got = _port_trace(trg, rays, SMALL, 8)
    _assert_same(got, _jax_numpy_trace(jrg, [x.numpy() for x in rays], SMALL,
                                       8))
    assert not bool(got.hit.any())
    assert int(got.steps.max()) == 0


@pytest.fixture(scope="module")
def svo(world):
    """The port's SVO world of the same chunks."""
    _, _, _, grids, cells, _ = world
    nodes, _ = build_chunk_svo_batch(grids, device="cpu")
    return assemble_world_slice(nodes, cells, np.zeros(3, np.int32), 4,
                                device="cpu")


@pytest.mark.parametrize("i", range(len(CAMS)))
def test_agrees_with_svo_reference(world, traces, svo, i):
    """The port's v1 trace against the port's SVO tracer on the same
    rays, under test_wavefront.py:60-96's bars: hits and voxel ids equal,
    hit positions and water close."""
    _, _, mats, _, _, rays = world
    origin, dirs = _port_rays(CAMS[i], SIZE)
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(rays[i][1]))
    ref = trace_rays(svo, torch.as_tensor(np.asarray(mats.is_liquid)),
                     origin, dirs, 500)
    wf = traces[i][0]
    rh, wh = ref.hit.numpy(), wf.hit.numpy()
    np.testing.assert_array_equal(rh, wh)
    m = rh & wh
    rv, wv = ref.voxel.numpy(), wf.voxel.numpy()
    np.testing.assert_array_equal(rv[m], wv[m])
    same = m & (rv == wv)
    wp = origin.numpy()[None, None] + dirs.numpy() * wf.t.numpy()[..., None]
    pd = np.abs(wp - ref.pos.numpy())[same].max(axis=-1)
    assert (pd < 0.51).mean() >= 0.75
    assert np.median(pd) < 0.01
    wd = np.abs(ref.water_dist.numpy() - wf.water_dist.numpy())
    assert np.median(wd) < 0.05


def test_step_heatmap_counts(world):
    _, trg, _, _, _, _ = world
    steps = _port_trace(trg, _port_rays(CAMS[0], SMALL), SMALL,
                        48).steps.numpy()
    assert steps.max() > 1  # the debug heatmap has signal
    assert steps.min() >= 0


def test_frame_must_be_whole_tiles(world):
    _, trg, _, _, _, _ = world
    o, d = torch.zeros(3), torch.zeros((180, 320, 3))
    with pytest.raises(ValueError, match="16x8 tiles"):
        t1.trace_wavefront(trg, o, d, width=320, height=180)


@pytest.fixture
def jax_rays_op_by_op(monkeypatch):
    """JAX's renderer with its camera rays made op by op."""
    orig = j_rt.generate_rays_raw

    def rays(*a, **k):
        with jax.disable_jit():
            return orig(*a, **k)

    monkeypatch.setattr(j_rt, "generate_rays_raw", rays)


@pytest.mark.parametrize("case", [("v1", 0, False), ("v4", 1, True)],
                         ids=["v1-cam0", "v4-cam1-heatmap"])
def test_render_matches_jax(world, jax_rays_op_by_op, case):
    """``render`` on a v1 grid: the v1 tracer at the renderer's 48 x 12
    budget for every tracer but v2, as JAX routes it, and
    ``shade_hits`` (heatmap scale ``max_rounds * inner_steps``)."""
    jrg, trg, mats, _, _, _ = world
    tracer, i, heat = case
    settings = dict(sun_pos=SUN, sky_color=(0.7, 0.9, 1.0))
    jimg, jwf = j_rt.WavefrontRenderer(
        mats, tracer=tracer, show_step_count=heat).render(
        jrg, JCamData.create(*CAMS[i], 70.0, SIZE),
        j_rt.RenderSettings(**settings))
    img, wf = t_rt.WavefrontRenderer(
        mats, tracer=tracer, show_step_count=heat).render(
        trg, CamData.create(*CAMS[i], 70.0, SIZE),
        t_rt.RenderSettings(**settings))
    assert img.dtype == torch.float32 and tuple(img.shape) == SIZE[::-1] + (3,)
    for f in ("hit", "voxel", "steps", "norm"):
        np.testing.assert_array_equal(getattr(wf, f).numpy(),
                                      np.asarray(getattr(jwf, f)), f)
    np.testing.assert_allclose(wf.t.numpy(), np.asarray(jwf.t), rtol=T_RTOL,
                               atol=0)
    np.testing.assert_allclose(wf.water_dist.numpy(),
                               np.asarray(jwf.water_dist), rtol=0,
                               atol=W_ATOL)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=0,
                               atol=IMG_ATOL)
