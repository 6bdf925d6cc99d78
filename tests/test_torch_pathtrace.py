"""The port's path tracer on the v4 route (``path_trace3``/``path_trace4``)
and on the v3 route (``path_trace3(v4=False)``), its key derivation,
material LUT and material fetch, against the JAX package on the CPU.

The 2-chunk worlds and camera of tests/test_pathtrace4.py:37-69 (demo
materials, and the mirror table where every material has scatter 0 and
voxel 1 emits), built by the JAX host builder and carried over with
``convert.render_grid3_from_numpy``, feed both packages. JAX runs as its
own tests run it on the CPU (Pallas in interpret mode, ``rounds=64``, a
budget at which its legs converge at 64x32; the v3 route also at
``rounds=2``, where they do not); the port runs its plain
PyTorch versions on CPU tensors. Each JAX golden is computed once, in a
module fixture.

Tolerances, each with its reason:
  * the key derivation, the LUT rows and the material fetch: bit for bit;
  * frames that draw no random number (``bounces=0``, mirror materials):
    ``rtol=1e-5, atol=1e-6``. The two libms round ``exp`` and ``** 0.35``
    differently by an ulp, and XLA contracts ``a*b+c`` into FMAs inside
    the interpret-mode kernel, which moves ``t`` by a few ulps (measured
    here: at most 2.7e-7 absolute, 5.4e-6 relative);
  * diffuse frames with a bounce: the path-tracing bar of
    tools/tpu_correctness.py:184-190, at least 99% of pixels with every
    channel within 2/255. Box-Muller's ``log``/``cos``/``sin`` differ by
    ulps between the libms, and an ulp in a bounce direction can flip a
    grazing voxel (measured here: every pixel within 2/255, at most
    3.6e-7 apart).
"""

import jax
import numpy as np
import pytest
import torch

from voxelraytracing_tpu.ops import noise as j_noise
from voxelraytracing_tpu.ops import wavefront3 as j3
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.ops.materials import make_material_table
from voxelraytracing_tpu.world.demo import demo_chunk_grids_host, demo_materials
from voxelraytracing_tpu_torch.convert import render_grid3_from_numpy
from voxelraytracing_tpu_torch.ops import pathtrace3 as p3
from voxelraytracing_tpu_torch.ops import prng
from voxelraytracing_tpu_torch.ops import wavefront3 as t3
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.ops.camera import CamData
from voxelraytracing_tpu_torch.ops.wavefront3 import RenderGrid3
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

SUN = (1000.0, 2500.0, 500.0)
CAM = ((30.0, 45.0, 0.0), (32.0, 40.0, 32.0), 70.0, (64, 32))
MIRROR = {
    1: {"color": (0.55, 0.55, 0.55), "state": "solid", "scatter": 0.0,
        "emission": 0.5},
    2: {"color": (0.55, 0.35, 0.15), "state": "solid", "scatter": 0.0},
    3: {"color": (0.30, 0.68, 0.24), "state": "solid", "scatter": 0.0},
    4: {"color": (0.12, 0.30, 0.85), "state": "liquid", "scatter": 0.0},
}
KEYS = (0, 1, 3, 7, 123456789)
# (scene, bounces, samples, key): the JAX goldens
RNG_FREE = (("diffuse", 0, 1, 0), ("mirror", 1, 1, 0), ("mirror", 2, 1, 0))
# one sample, so that its program is the mirror frame's (bounces=1):
# the JAX compile is shared; tests/test_torch_pt_fused.py draws two
DIFFUSE = ("diffuse", 1, 1, 3)
# two bounces, the program of ("mirror", 2, 1, 0): the second bounce's
# direction draws from fold_in(skey, 1), which one bounce never reaches
DIFFUSE2 = ("diffuse", 2, 1, 3)
# the v3 route (v4=False) at a starved budget, where it is not the v4 frame
V3_ROUNDS = 2


def _scene(mats):
    w = 2
    grids, cells = demo_chunk_grids_host(
        j_noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    jrg = j3.build_render_grid3_host(grids, cells, np.zeros(3, np.int32), w,
                                     mats)
    trg = render_grid3_from_numpy(
        *[np.asarray(getattr(jrg, f)) for f in RenderGrid3._fields],
        device="cpu")
    return jrg, trg, mats


@pytest.fixture(scope="module")
def scenes():
    """Both worlds, and the JAX path_trace3 frames of RNG_FREE, DIFFUSE
    and DIFFUSE2 (five JAX path-trace calls, three programs)."""
    sc = {"diffuse": _scene(demo_materials()),
          "mirror": _scene(make_material_table(256, MIRROR))}
    cam = JCamData.create(*CAM)
    gold = {}
    for name, bounces, samples, key in RNG_FREE + (DIFFUSE, DIFFUSE2):
        jrg, _, mats = sc[name]
        gold[name, bounces] = np.asarray(j3.path_trace3(
            jrg, cam, mats, sun_pos=SUN, bounces=bounces, samples=samples,
            key=jax.random.PRNGKey(key), rounds=64, step_cap=500, v4=True))
    jrg, _, mats = sc["diffuse"]
    gold["v3"] = np.asarray(j3.path_trace3(
        jrg, cam, mats, sun_pos=SUN, bounces=1, key=jax.random.PRNGKey(0),
        rounds=V3_ROUNDS, step_cap=500))
    return sc, gold


def _port(trg, mats, bounces, samples=1, key=0, fn=p3.path_trace3, **kw):
    img = fn(trg, CamData.create(*CAM), mats, sun_pos=SUN, bounces=bounces,
             samples=samples, key=np.asarray(jax.random.PRNGKey(key)),
             step_cap=500, **kw)
    assert img.dtype == torch.float32 and img.device.type == "cpu"
    return img.numpy()


def pt_bar(a, b):
    """Share of pixels whose every channel is within 2/255."""
    d = np.abs(a.astype(np.float64) - b.astype(np.float64)).max(axis=-1)
    return float((d <= 2.0 / 255.0).mean())


@pytest.mark.parametrize("seed", KEYS)
def test_split_and_fold_in_match_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    kd = np.asarray(key)
    for num in (1, 2, 5):
        np.testing.assert_array_equal(prng.split(kd, num),
                                      np.asarray(jax.random.split(key, num)))
    for data in (0, 1, 2, 77):
        np.testing.assert_array_equal(
            prng.fold_in(kd, data), np.asarray(jax.random.fold_in(key, data)))
    # the derivation path_trace3 takes: fold_in(split(key)[s], bounce)
    skeys = jax.random.split(key, 3)
    np.testing.assert_array_equal(
        prng.fold_in(prng.split(kd, 3)[2], 1),
        np.asarray(jax.random.fold_in(skeys[2], 1)))


def test_key_none_is_prng_key_0():
    np.testing.assert_array_equal(prng.key_data(None),
                                  np.asarray(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="uint32"):
        prng.key_data(np.zeros(3, np.uint32))


@pytest.mark.parametrize("table", ["demo", "mirror", "random"])
def test_material_lut_rows_match_jax(table):
    if table == "demo":
        m = demo_materials()
        args = (m.color, m.emission, m.scatter)
    elif table == "mirror":
        m = make_material_table(256, MIRROR)
        args = (m.color, m.emission, m.scatter)
    else:
        rng = np.random.default_rng(5)
        args = (rng.random((200, 3)), rng.random(200), rng.random(200))
    got = t3.material_lut_rows(*args)
    assert got.dtype == torch.float32 and got.shape == (10, 128)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j3.material_lut_rows(*args)))


def test_matfetch_matches_jax_kernel(scenes):
    """The plain material fetch against JAX ``_matfetch`` (interpret mode)
    on the flags of a traced frame (the port's march, whose flags equal
    JAX's: tests/test_torch_split.py), then on words that carry every hit
    id under random other bits."""
    sc, _ = scenes
    _, trg, mats = sc["diffuse"]
    args, _ = p3.pt_inputs(trg, CamData.create(*CAM), mats, sun_pos=SUN,
                           step_cap=500)
    fl = t4.march_planes4_ref(args[0], args[1], args[3], args[4], height=32,
                              width=64)[1].numpy().view(np.uint32)
    assert ((fl >> 1) & 1).any()
    rng = np.random.default_rng(11)
    extra = rng.integers(0, 2**32, 64 * 128 - fl.size, dtype=np.uint64)
    ids = np.arange(extra.size, dtype=np.uint64) % 256
    extra = (extra & ~np.uint64(0xFF << 17)) | (ids << np.uint64(17))
    words = np.concatenate([np.asarray(fl, np.uint32).ravel(),
                            extra.astype(np.uint32)]).reshape(64, 128)
    assert ((words >> 17) & 0xFF).any() and len(np.unique(words >> 17 & 0xFF)) == 256
    mlut = j3.material_lut_rows(mats.color, mats.emission, mats.scatter)
    want = j3._matfetch(mlut[None], words, interpret=True)
    got = p3.matfetch4_ref(torch.from_numpy(words.view(np.int32)),
                           t3.material_lut_rows(mats.color, mats.emission,
                                                mats.scatter))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", RNG_FREE, ids=lambda c: f"{c[0]}-b{c[1]}")
def test_path_trace3_without_draws_matches_jax(scenes, case):
    sc, gold = scenes
    name, bounces, samples, key = case
    _, trg, mats = sc[name]
    got = _port(trg, mats, bounces, samples, key, v4=True)
    np.testing.assert_allclose(got, gold[name, bounces], rtol=1e-5, atol=1e-6)
    assert (got > 0).any()


def test_path_trace3_diffuse_meets_the_pt_bar(scenes):
    """One bounce on the demo materials: the key's split and fold-in and
    the tiled ray ids draw what JAX draws."""
    sc, gold = scenes
    name, bounces, samples, key = DIFFUSE
    _, trg, mats = sc[name]
    got = _port(trg, mats, bounces, samples, key, v4=True)
    want = gold[name, bounces]
    assert pt_bar(got, want) >= 0.99
    assert abs(float(got.mean()) - float(want.mean())) < 1e-3 * float(want.mean())
    # another key draws other directions
    other = _port(trg, mats, bounces, samples, key + 1, v4=True)
    assert pt_bar(other, want) < 0.99


def test_path_trace3_second_bounce_draws_match_jax(scenes):
    """Two bounces on the demo materials: the draws of the second bounce
    (``fold_in(skey, 1)``) and the legs after them are JAX's, at the bars
    of the frames that draw nothing."""
    sc, gold = scenes
    name, bounces, samples, key = DIFFUSE2
    _, trg, mats = sc[name]
    got = _port(trg, mats, bounces, samples, key, v4=True)
    want = gold[name, bounces]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the second bounce adds light the one-bounce frame lacks
    assert not np.allclose(want, gold[DIFFUSE[0], DIFFUSE[1]], atol=1e-3)


def test_routes_of_the_v3_api_are_one(scenes):
    """``path_trace4`` and the TPU schedule knobs the repository's callers
    pass give the v4 route's frame; ``v4=False`` (JAX's default) marches
    every leg through the v3 round loop and meets the bar of JAX's v3
    route, which at a starved budget is not the v4 frame."""
    sc, gold = scenes
    _, trg, mats = sc["diffuse"]
    a = _port(trg, mats, 1, v4=True)
    np.testing.assert_array_equal(_port(trg, mats, 1, fn=p3.path_trace4), a)
    v3 = _port(trg, mats, 1, v4=False, rounds=V3_ROUNDS)
    assert pt_bar(v3, gold["v3"]) >= 0.99
    assert abs(float(v3.mean()) - float(gold["v3"].mean())) < 1e-3 * float(
        gold["v3"].mean())
    assert pt_bar(v3, a) < 0.99
    knobs = dict(rounds=2, steps_per_round=16, bounce_rounds=2,
                 compact_tiles=64, compact_lanes=True, retry_rounds1=1,
                 compact_tiles2=64, prim_rounds=1, prim_compact=64,
                 prim_steps_per_round=256, prim_s_seg=4, bounce_sort=True,
                 bounce_rebin=3, bounce_wm_full=True, bounce_spin_ramp=1,
                 bounce_steps_per_round=256)
    np.testing.assert_array_equal(_port(trg, mats, 1, v4=True, **knobs), a)
    with pytest.raises(TypeError, match="bounce_rounds_typo"):
        _port(trg, mats, 1, v4=True, bounce_rounds_typo=2)


def test_v3_route_legs_hand_over_contiguous_planes(scenes):
    """The v3 route's legs return contiguous [H, W] planes, as the v4
    legs do: :func:`matfetch4`'s kernel refuses a view, and a frame whose
    superblocks overhang it untiles into one (64x32 here, 128x64 of
    superblocks), which made every v3-route frame raise on the card."""
    sc, _ = scenes
    _, trg, mats = sc["diffuse"]
    cam = CamData.create(*CAM)
    args, (h, w) = p3.pt_inputs(trg, cam, mats, sun_pos=SUN, step_cap=500)
    primary, bounce = p3._v3_legs(trg, cam, args[0], height=h, width=w,
                                  rounds=V3_ROUNDS, sub_rounds=6,
                                  step_cap=500)
    o = torch.full((h, w, 3), 20.0)
    d = torch.nn.functional.normalize(torch.ones(h, w, 3), dim=-1)
    for planes in (primary(), bounce(o, d, torch.ones(h, w, dtype=torch.bool))):
        assert [tuple(p.shape) for p in planes] == [(h, w)] * 4
        assert all(p.is_contiguous() for p in planes)


def test_cache_token_is_inert(scenes):
    sc, _ = scenes
    _, trg, mats = sc["mirror"]
    cam = CamData.create(*CAM)
    img, tok = p3.path_trace3(trg, cam, mats, sun_pos=SUN, bounces=1,
                              step_cap=500, v4=True, return_cache=True)
    again = p3.path_trace3(trg, cam, mats, sun_pos=SUN, bounces=1,
                           step_cap=500, v4=True, cache=tok)
    assert torch.equal(img, again)
    assert tok.shape == (1, 2, 128) and bool((tok == -1).all())
