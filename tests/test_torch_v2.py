"""The port's v2 path against the JAX package on the CPU: the v1 world
tables, the v2 march (``march2_ref``, the plain version of
``csrc/march2.cu``), ``trace_wavefront2``, the sky, ``shade_hits`` and
``WavefrontRenderer.render`` on a v1 grid.

The world is the 4-chunk demo world of tests/torch_v3_scene.py (noise seed
7), built by both packages' ``build_render_grid_host``; the cameras are
its CAMS. JAX runs its Pallas kernel in interpret mode, as its own tests
do; each golden is computed once, in a module fixture, at one frame size
(64x32) and two round budgets (``rounds`` is static in JAX's
``_trace_frame``, so each budget is one compile): the renderer's 48
rounds of 24 steps, and a starved 2 rounds of 24. The JAX rays are made
op by op (``jax.disable_jit()``): XLA's CPU compiler contracts the eager
``jnp.linalg.norm`` so that some directions move by an ulp
(tests/test_torch_camera.py).

Tolerances, each with its reason: hits, ids, steps, normals, wants and
integer state agree exactly; ``t`` within ``T_RTOL`` relative and water
within ``W_ATOL`` absolute (XLA's CPU FMA contraction inside the
interpret-mode kernel, tests/torch_v3_scene.py; measured here at most
1.9e-6 relative and 2.3e-5). Shaded images within ``IMG_ATOL``: JAX
jits the shade, so the same contraction reaches the water overlay
(measured 1.55e-6).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)
from torch_v2_state import STRANDED, go_probe
from torch_v3_scene import CAMS, SIZE, SUN, T_RTOL, W_ATOL
import voxelraytracing_tpu.models.raytracer as j_rt
from voxelraytracing_tpu.ops import noise as j_noise
from voxelraytracing_tpu.ops import sky as j_sky
from voxelraytracing_tpu.ops import traverse as j_traverse
from voxelraytracing_tpu.ops import wavefront as j1
from voxelraytracing_tpu.ops import wavefront2 as j2
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.ops.camera import generate_rays as j_generate_rays
from voxelraytracing_tpu.world.demo import demo_chunk_grids_host, demo_materials
from voxelraytracing_tpu_torch.convert import render_grid_from_numpy
from voxelraytracing_tpu_torch.models import raytracer as t_rt
from voxelraytracing_tpu_torch.ops import sky as t_sky
from voxelraytracing_tpu_torch.ops import traverse as t_traverse
from voxelraytracing_tpu_torch.ops import wavefront as t1
from voxelraytracing_tpu_torch.ops import wavefront2 as t2
from voxelraytracing_tpu_torch.ops.camera import CamData

BUDGETS = ((48, 24), (2, 24))  # (rounds, steps_per_round)
IMG_ATOL = 4e-6
OUTSIDE = ((30.0, 45.0, 0.0), (-50.0, 75.0, 64.0))


def _jax_rays(rot, eye):
    with jax.disable_jit():
        return j_generate_rays(JCamData.create(rot, eye, 70.0, SIZE),
                               np.zeros(3, np.int32))


@pytest.fixture(scope="module")
def world():
    """The v1 grids of both packages, JAX's rays of each camera and its
    trace at each budget."""
    w = 4
    grids, cells = demo_chunk_grids_host(
        j_noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    mats = demo_materials()
    wmin = np.zeros(3, np.int32)
    jrg = j1.build_render_grid_host(grids, cells, wmin, w, mats)
    trg = t1.build_render_grid_host(grids, cells, wmin, w, mats,
                                    device="cpu")
    rays, gold = {}, {}
    for i, cam in enumerate(CAMS + [OUTSIDE]):
        rays[i] = _jax_rays(*cam)
        for rounds, spr in BUDGETS:
            if i == len(CAMS) and rounds != 2:
                continue
            gold[i, rounds] = j2.trace_wavefront2(
                jrg, *rays[i], width=SIZE[0], height=SIZE[1], rounds=rounds,
                steps_per_round=spr)
    return jrg, trg, mats, rays, gold


def _port_trace(trg, rays, rounds, spr):
    o, d = (torch.tensor(np.asarray(x)) for x in rays)
    return t2.trace_wavefront2(trg, o, d, width=SIZE[0], height=SIZE[1],
                               rounds=rounds, steps_per_round=spr)


def _assert_result(got, want):
    for f in ("hit", "voxel", "steps", "norm"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                               rtol=T_RTOL, atol=0)
    np.testing.assert_allclose(got.water_dist.numpy(),
                               np.asarray(want.water_dist), rtol=0,
                               atol=W_ATOL)


def test_tables_and_global_planes_match_jax(world):
    """``build_render_grid_host`` and ``_global_planes``, word for word;
    the v3 builder's brick tables are the same arrays."""
    jrg, trg, _, _, _ = world
    for f in ("bwin", "lwin", "brick_dir", "bricks", "world_min", "to_pack"):
        a, b = getattr(trg, f).numpy(), np.asarray(getattr(jrg, f))
        if b.dtype == np.uint32:
            a = a.view(np.uint32)
        np.testing.assert_array_equal(a, b, f)
    assert trg.n_liquid == int(jrg.n_liquid)
    assert trg.size_voxels == jrg.size_voxels
    for a, b in zip(t2._global_planes(trg.bwin, trg.lwin),
                    j2._global_planes(jrg.bwin, jrg.lwin)):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b))
    # the scene has jumpable (sky) windows and descend bricks
    gj = t2._global_planes(trg.bwin, trg.lwin)[0]
    assert bool((gj != 0).any()) and bool((trg.bwin != 0).any())
    carried = render_grid_from_numpy(
        *[np.asarray(getattr(jrg, f)) for f in t1.RenderGrid._fields],
        device="cpu")
    for f in ("bwin", "lwin", "brick_dir", "bricks"):
        assert torch.equal(getattr(carried, f), getattr(trg, f)), f


@pytest.mark.parametrize("budget", BUDGETS, ids=["48x24", "2x24"])
@pytest.mark.parametrize("cam", range(len(CAMS)))
def test_trace_wavefront2_matches_jax(world, cam, budget):
    _, trg, _, rays, gold = world
    _assert_result(_port_trace(trg, rays[cam], *budget),
                   gold[cam, budget[0]])


def test_budget_decides_the_frame(world):
    """What the budgets pin: at 2 rounds every ray that needs a brick is
    still stalled (sky), at 48 the frame has hits."""
    _, _, _, _, gold = world
    for i in range(3):
        assert not np.asarray(gold[i, 2].hit).any()
        assert np.asarray(gold[i, 48].hit).sum() > 100


def test_camera_outside_world_sees_nothing(world):
    _, trg, _, rays, gold = world
    got = _port_trace(trg, rays[len(CAMS)], 2, 24)
    _assert_result(got, gold[len(CAMS), 2])
    assert not bool(got.hit.any())
    assert int(got.steps.max()) == 0


def test_step_counts(world):
    """The per-ray step counts the heatmap reads: exact, and the 2-round
    budget's cap (2 rounds x 2 sub-rounds x 12 steps x 2 phases) holds."""
    _, trg, _, rays, gold = world
    got = _port_trace(trg, rays[0], 2, 24)
    steps = got.steps.numpy()
    np.testing.assert_array_equal(steps, np.asarray(gold[0, 2].steps))
    assert steps.max() > 1 and steps.min() >= 0 and steps.max() <= 96


def _jax_march(static, args):
    """JAX's ``_march`` on the port's round inputs (cache ids replicated
    over lanes, bit words as uint32)."""
    (scal, dx, dy, dz, gj, gl, wid, bwc, lwc, bid, cnt, *state) = [
        x.numpy() for x in args]
    n = wid.shape[0]

    def u32(x):
        return x.view(np.uint32)

    outs = static(
        scal, dx, dy, dz, np.broadcast_to(u32(gj)[None], (n, 1, 128)),
        np.broadcast_to(u32(gl)[None], (n, 1, 128)),
        np.broadcast_to(wid[:, :, None], (n, t2.N_WCACHE, 128)),
        u32(bwc), u32(lwc),
        np.broadcast_to(bid[:, :, None], (n, t2.N_BCACHE, 128)), u32(cnt),
        *state)
    return [np.asarray(x) for x in outs]


def _assert_round(got, want):
    for k, a, b in zip(t2.STATE + ("want_win", "want_br"), got, want):
        a = a.numpy()
        if k == "t":
            np.testing.assert_allclose(a, b, rtol=T_RTOL, atol=0, err_msg=k)
        elif k in t2._FLOAT_PLANES:
            np.testing.assert_allclose(a, b, rtol=0, atol=W_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, k)


@functools.lru_cache(maxsize=None)
def _jitted(sub_rounds, nb, bg_side):
    return jax.jit(functools.partial(
        j2._march, sub_rounds=sub_rounds, sub_steps=t2.SUB_STEPS, nb=nb,
        bg_side=bg_side, interpret=True))


def test_march2_ref_matches_jax_launch_by_launch(world):
    """Every round of the renderer's budget on camera 2: the port's round
    loop serves the wants and feeds the same scalar row, caches and state
    to ``march2_ref`` and to JAX's ``_march``; states and wants agree."""
    _, trg, _, rays, gold = world
    ref = t2.march2_ref
    seen = []

    def both(*args, **kw):
        out = ref(*args, **kw)
        want = _jax_march(_jitted(kw["sub_rounds"], kw["nb"],
                                  kw["bg_side"]), args)
        _assert_round(out, want)
        seen.append(int(out[1].sum()))
        return out

    t2.march2_ref = both
    try:
        got = _port_trace(trg, rays[2], 48, 24)
    finally:
        t2.march2_ref = ref
    assert len(seen) == 48 and seen[0] > seen[-1], seen
    _assert_result(got, gold[2, 48])


def test_go_is_program_wide(world):
    """The hand-made round of tests/torch_v2_state.py: a tile whose only
    active ray cannot march, in a program where another tile can. JAX
    steps the whole program, so that ray is demoted (wavefront2.py:298);
    ``march2_ref`` equals JAX's ``_march`` on it."""
    _, trg, _, _, _ = world
    args, kw = go_probe(trg, "cpu")
    out = t2.march2_ref(*args, **kw)
    _assert_round(out, _jax_march(_jitted(kw["sub_rounds"], kw["nb"],
                                          kw["bg_side"]), args))
    level_in, level_out = args[11 + 3], out[3]
    assert int(level_in[STRANDED]) == 1 and int(level_out[STRANDED]) == 0


def _shade_inputs(seed, n=2048):
    """Seeded hits, ids, normals (every face, both signs), water lengths
    (zero, short, past the overlay's cap) and steps."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.sqrt((d * d).sum(axis=1, keepdims=True)).astype(np.float32)
    axis = rng.integers(0, 4, n)
    norm = np.zeros((n, 3), np.float32)
    face = axis < 3
    norm[face, axis[face]] = rng.choice([-1.0, 1.0], face.sum())
    water = np.where(rng.random(n) < 0.4,
                     rng.uniform(0.0, 30.0, n), 0.0).astype(np.float32)
    return dict(hit=rng.random(n) < 0.6,
                voxel=rng.integers(0, 9, n).astype(np.int32), norm=norm,
                pos=rng.uniform(0, 128, (n, 3)).astype(np.float32),
                water_dist=water,
                steps=rng.integers(0, 800, n).astype(np.int32)), d


@pytest.mark.parametrize("show_steps", [False, True])
def test_sky_and_shade_hits_match_jax(show_steps):
    fields, d = _shade_inputs(3)
    mats = demo_materials()
    origin = np.asarray((64.0, 75.0, 64.0), np.float32)
    kw = dict(sky_color=(0.81, 0.93, 1.0), sun_pos=SUN, sun_intensity=4.0,
              world_min=np.asarray((3, -2, 5), np.int32))
    np.testing.assert_allclose(
        t_sky.ray_sky(torch.from_numpy(d), torch.from_numpy(origin),
                      **kw).numpy(),
        np.asarray(j_sky.ray_sky(d, origin, **kw)), rtol=0, atol=IMG_ATOL)
    assert (fields["norm"][:, 1] == -1.0).any()
    got = t_rt.shade_hits(
        t_traverse.TraceResult(**{k: torch.from_numpy(np.asarray(v))
                                  for k, v in fields.items()}),
        torch.from_numpy(d), torch.from_numpy(origin), mats, **kw,
        show_step_count=show_steps, max_steps=576)
    want = j_rt.shade_hits(j_traverse.TraceResult(**fields), d, origin, mats,
                           **kw, show_step_count=show_steps, max_steps=576)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=IMG_ATOL)


@pytest.fixture
def jax_rays_op_by_op(monkeypatch):
    """JAX's renderer with its rays made op by op (see the module text)."""
    orig = j_rt.generate_rays_raw

    def rays(*a, **k):
        with jax.disable_jit():
            return orig(*a, **k)

    monkeypatch.setattr(j_rt, "generate_rays_raw", rays)


@pytest.mark.parametrize("case", [(0, False), (2, False), (0, True)],
                         ids=["cam0", "cam2", "cam0-heatmap"])
def test_render_matches_jax(world, jax_rays_op_by_op, case):
    """``render`` on a v1 grid: the v2 march at the renderer's 48 x 24
    budget and ``shade_hits`` (heatmap scale ``max_rounds *
    inner_steps``)."""
    jrg, trg, mats, _, _ = world
    i, steps = case
    settings = dict(sun_pos=SUN, sky_color=(0.7, 0.9, 1.0))
    jimg, jwf = j_rt.WavefrontRenderer(mats, show_step_count=steps).render(
        jrg, JCamData.create(*CAMS[i], 70.0, SIZE),
        j_rt.RenderSettings(**settings))
    img, wf = t_rt.WavefrontRenderer(mats, show_step_count=steps).render(
        trg, CamData.create(*CAMS[i], 70.0, SIZE),
        t_rt.RenderSettings(**settings))
    assert img.dtype == torch.float32 and tuple(img.shape) == SIZE[::-1] + (3,)
    _assert_result(wf, jwf)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=0,
                               atol=IMG_ATOL)


def test_render_refuses_the_v1_tracer(world):
    _, trg, mats, _, _ = world
    cam = CamData.create(*CAMS[0], 70.0, SIZE)
    for tracer in ("v1", "v4"):  # JAX runs the v1 tracer for both
        with pytest.raises(NotImplementedError, match="v1 tracer"):
            t_rt.WavefrontRenderer(mats, tracer=tracer).render(trg, cam)
