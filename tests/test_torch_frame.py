"""The port's fused v4 primary frame against the JAX package's.

One 4-chunk demo world, built by the JAX host builder and carried over
with ``convert.render_grid3_from_numpy``, feeds both packages. The JAX
frame is ``render_frame4(fused=True)``, whose Pallas kernel runs in
interpret mode on the CPU; the port's runs its plain PyTorch version on
CPU tensors. Flags must be equal word for word, packed RGBA8 too, except
that on sky pixels the two libms may round ``sky_gradient ** 0.35``
differently: there a channel may differ by 1/255.

The CUDA kernel is held against the plain version in
test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from voxelraytracing_tpu.models.raytracer import (
    RenderSettings as JRenderSettings,
    WavefrontRenderer as JWavefrontRenderer,
    to_srgb8 as j_to_srgb8,
)
from voxelraytracing_tpu.ops import noise as j_noise
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.ops.wavefront3 import build_render_grid3_host
from voxelraytracing_tpu.ops.wavefront4 import render_frame4 as j_render_frame4
from voxelraytracing_tpu.ops.wavefront4 import trace_wavefront4
from voxelraytracing_tpu.world.demo import demo_chunk_grids_host, demo_materials
from voxelraytracing_tpu_torch.convert import render_grid3_from_numpy
from voxelraytracing_tpu_torch.models.raytracer import (
    STEP_CAP,
    STEPS_PER_ROUND,
    RenderSettings,
    WavefrontRenderer,
    to_srgb8,
)
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.ops.camera import CamData
from voxelraytracing_tpu_torch.ops.wavefront3 import RenderGrid3, _sb_dims
from torch_nan_camera import NAN_SKY, zero_basis
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

PLANES = ("gw_jump", "gw_liq", "wmeta", "sw_meta", "sw_solid", "sw_liq",
          "sw_pid")
# test_wavefront4.py:44-49
CAMS = [
    ((30.0, 45.0, 0.0), (64.0, 75.0, 64.0)),
    ((5.0, 120.0, 0.0), (20.0, 40.0, 100.0)),
    ((60.0, 200.0, 0.0), (100.0, 110.0, 30.0)),
    ((-20.0, 300.0, 0.0), (64.0, 20.0, 64.0)),  # underwater, looking up
]
OUTSIDE = ((30.0, 45.0, 0.0), (-50.0, 75.0, 64.0))
SHIFT = (32, -64, 0)  # a world whose min corner is not the origin
SHIFTED_CAM = ((30.0, 45.0, 0.0), (64.0 + 32, 75.0 - 64, 64.0))
KW = dict(sun_pos=(1000.0, 2500.0, 500.0), step_cap=500, rounds=64,
          with_flags=True, fused=True)
SIZE = (64, 32)


def _jax_frame(jrg, mats, cam_cfg, size=SIZE, **kw):
    cam = JCamData.create(cam_cfg[0], cam_cfg[1], 70.0, size)
    img, fl = j_render_frame4(jrg, cam, mats.color, **{**KW, **kw})
    return np.asarray(img), np.asarray(fl)


@pytest.fixture(scope="module")
def world():
    """The world both packages render, and the JAX goldens: each JAX
    program shape compiles once for the whole file."""
    w = 4
    perm = j_noise.make_permutation(7)
    grids, cells = demo_chunk_grids_host(
        perm, np.zeros(3, np.int64), w, w * 32 * 0.45, int(w * 32 * 0.28))
    mats = demo_materials()
    jrg = build_render_grid3_host(grids, cells, np.zeros(3, np.int32), w, mats)
    trg = render_grid3_from_numpy(
        *[np.asarray(getattr(jrg, f)) for f in RenderGrid3._fields],
        device="cpu")
    gold = {f"cam{i}": _jax_frame(jrg, mats, c) for i, c in enumerate(CAMS)}
    gold["outside"] = _jax_frame(jrg, mats, OUTSIDE)
    gold["cap20"] = _jax_frame(jrg, mats, CAMS[0], step_cap=20)
    gold["steps"] = _jax_frame(jrg, mats, CAMS[0], show_steps=True)
    gold["ragged"] = _jax_frame(jrg, mats, CAMS[2], size=(72, 36))
    gold["nan"] = tuple(np.asarray(x) for x in j_render_frame4(
        jrg, zero_basis(JCamData.create(*CAMS[0], 70.0, SIZE)), mats.color,
        **KW))
    for i, (rot, eye) in enumerate(CAMS):
        gold[f"trace{i}"] = trace_wavefront4(
            jrg, np.asarray(eye, np.float32), step_cap=500, rounds=64,
            cam=JCamData.create(rot, eye, 70.0, SIZE))
    gold["shifted"] = _jax_frame(
        jrg._replace(world_min=np.asarray(SHIFT, np.int32)), mats, SHIFTED_CAM)
    return jrg, trg, mats, gold


def _port_frame(trg, mats, cam_cfg, size=SIZE, **kw):
    cam = CamData.create(cam_cfg[0], cam_cfg[1], 70.0, size)
    img, fl = t4.render_frame4(trg, cam, mats.color, **{**KW, **kw})
    assert img.dtype == fl.dtype == torch.int32
    return img.numpy().view(np.uint32), fl.numpy()


def assert_frames_match(port, gold):
    (img, fl), (jimg, jfl) = port, gold
    assert img.shape == jimg.shape and fl.shape == jfl.shape
    np.testing.assert_array_equal(fl, jfl)
    differ = img != jimg
    sky = ((jfl >> 1) & 1) == 0
    assert not (differ & ~sky).any(), "a hit pixel's color differs"
    for sh in (0, 8, 16):
        ch = np.abs(((img >> sh) & 255).astype(int)
                    - ((jimg >> sh) & 255).astype(int))
        assert ch.max() <= 1, "a sky channel differs by more than 1/255"
    assert ((img >> 24) == 255).all()


@pytest.mark.parametrize("i", range(len(CAMS)))
def test_fused_frame_matches_jax(world, i):
    _, trg, mats, gold = world
    port = _port_frame(trg, mats, CAMS[i])
    assert_frames_match(port, gold[f"cam{i}"])
    assert ((port[1] >> 1) & 1).any()  # the camera sees terrain


@pytest.mark.parametrize("i", range(len(CAMS)))
def test_march_products_match_jax_trace(world, i):
    """The plain march's per-ray products against JAX ``trace_wavefront4``
    (same march, split path). Hits, ids and step counts are exact. ``t``
    and the water length carry a tolerance: XLA contracts ``a*b+c`` into
    FMAs inside the interpret-mode kernel (positions, directions, DDA
    exits), which moves ``t`` by a few ulps (measured <= 6.2e-7 relative),
    and the water length is a difference of two such ``t`` (measured
    <= 4.6e-5 absolute)."""
    _, trg, mats, gold = world
    ref = gold[f"trace{i}"]
    cam = CamData.create(CAMS[i][0], CAMS[i][1], 70.0, SIZE)
    args, _ = t4.frame_args(trg, cam, mats.color, step_cap=500)
    m = t4.march_ref(args[0], args[1], args[3], args[4],
                     height=SIZE[1], width=SIZE[0])

    def img(x):
        return x.reshape(SIZE[1], SIZE[0]).numpy()

    hit = img(m.hit)
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    np.testing.assert_array_equal(np.where(hit, img(m.vox), 0),
                                  np.asarray(ref.voxel))
    np.testing.assert_array_equal(img(m.stp), np.asarray(ref.steps))
    np.testing.assert_allclose(img(m.t), np.asarray(ref.t), rtol=2e-6, atol=0)
    np.testing.assert_allclose(img(m.water), np.asarray(ref.water_dist),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("i", range(len(CAMS)))
def test_trace_wavefront4_matches_jax(world, i):
    """The port's ``trace_wavefront4`` (the state-plane march of the
    camera rays and its WavefrontResult finish) against JAX's, under the
    tolerances of test_march_products_match_jax_trace; normals exact."""
    _, trg, _, gold = world
    ref = gold[f"trace{i}"]
    cam = CamData.create(CAMS[i][0], CAMS[i][1], 70.0, SIZE)
    res = t4.trace_wavefront4(trg, np.asarray(CAMS[i][1], np.float32),
                              cam=cam, step_cap=500, rounds=64)
    for f in ("hit", "voxel", "steps", "norm"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(ref.t), rtol=2e-6,
                               atol=0)
    np.testing.assert_allclose(res.water_dist.numpy(),
                               np.asarray(ref.water_dist), rtol=0, atol=1e-4)


def test_fused_frame_camera_outside_world(world):
    _, trg, mats, gold = world
    port = _port_frame(trg, mats, OUTSIDE)
    assert_frames_match(port, gold["outside"])
    assert not ((port[1] >> 1) & 1).any()


def test_fused_frame_nan_direction_matches_jax(world):
    """A camera with no basis: every direction NaN, no step, and JAX's
    packed words (a NaN sky is byte 0) and flags exactly."""
    _, trg, mats, gold = world
    img, fl = t4.render_frame4(
        trg, zero_basis(CamData.create(*CAMS[0], 70.0, SIZE)), mats.color,
        **KW)
    jimg, jfl = gold["nan"]
    assert (jimg.view(np.uint32) == NAN_SKY).all() and (jfl == 0).all()
    np.testing.assert_array_equal(img.numpy().view(np.uint32), jimg)
    np.testing.assert_array_equal(fl.numpy(), jfl)


def test_fused_frame_step_cap(world):
    _, trg, mats, gold = world
    port = _port_frame(trg, mats, CAMS[0], step_cap=20)
    assert_frames_match(port, gold["cap20"])
    assert ((port[1] >> 5) & 0xFFF).max() == 20


def test_fused_frame_show_steps(world):
    _, trg, mats, gold = world
    assert_frames_match(_port_frame(trg, mats, CAMS[0], show_steps=True),
                        gold["steps"])


def test_fused_frame_ragged_size(world):
    """72x36: the last 8 columns and 4 rows are partial tiles, which stay
    inactive and shade as sky, as in the JAX frame."""
    _, trg, mats, gold = world
    port = _port_frame(trg, mats, CAMS[2], size=(72, 36))
    assert_frames_match(port, gold["ragged"])
    assert not ((port[1][:, 64:] >> 1) & 1).any()


def test_fused_frame_world_min_offset(world):
    _, trg, mats, gold = world
    rg = trg._replace(world_min=torch.tensor(SHIFT, dtype=torch.int32))
    port = _port_frame(rg, mats, SHIFTED_CAM)
    assert_frames_match(port, gold["shifted"])
    assert ((port[1] >> 1) & 1).any()


def test_render_packed_matches_jax(world):
    """WavefrontRenderer end to end on its v4 route (split march | shade)
    in both packages, over two frames so the warm token is carried; the
    fused frame's flags say which pixels are sky (cameras inside the
    world, where split and fused frames agree)."""
    jrg, trg, mats, _ = world
    s_j = JRenderSettings(sun_pos=(1000.0, 2500.0, 500.0))
    s_t = RenderSettings(sun_pos=(1000.0, 2500.0, 500.0))
    jr = JWavefrontRenderer(mats, tracer="v4")
    tr = WavefrontRenderer(mats, tracer="v4")
    for cfg in CAMS[1:3]:
        a = np.asarray(jr.render_packed(
            jrg, JCamData.create(cfg[0], cfg[1], 70.0, SIZE), s_j))
        cam = CamData.create(cfg[0], cfg[1], 70.0, SIZE)
        b = tr.render_packed(trg, cam, s_t)
        # the port's flags of the same frame say which pixels are sky
        _, fl = t4.render_frame4(
            trg, cam, mats.color, sun_pos=s_t.sun_pos, with_flags=True,
            steps_per_round=STEPS_PER_ROUND, step_cap=STEP_CAP,
            fused=True)
        assert_frames_match((b.numpy().view(np.uint32), fl.numpy()),
                            (a, fl.numpy()))
    assert tr._prepared_for is trg


def test_settings_and_srgb8_match_jax():
    assert RenderSettings() == RenderSettings(**vars(JRenderSettings()))
    img = np.random.default_rng(4).uniform(-0.5, 1.5, (7, 9, 3))
    img = img.astype(np.float32)
    np.testing.assert_array_equal(to_srgb8(torch.from_numpy(img)),
                                  j_to_srgb8(img))


def test_cpu_tensors_take_the_plain_version(world):
    _, trg, mats, _ = world
    before = t4.march_fused4.launches
    cam = CamData.create(CAMS[0][0], CAMS[0][1], 70.0, SIZE)
    args, kw = t4.frame_args(trg, cam, mats.color, step_cap=500)
    a = t4.march_fused4(*args, **kw)
    b = t4.march_fused4_ref(*args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert t4.march_fused4.launches == before


def test_prepared_tables_and_token(world):
    _, trg, mats, _ = world
    cam = CamData.create(CAMS[1][0], CAMS[1][1], 70.0, (80, 40))
    prep = t4.prepare_grid4(trg)
    img, fl, (tok, shadow_tok) = t4.render_frame4(
        trg, cam, mats.color, prepared=prep, return_cache=True, **KW)
    img2, fl2 = t4.render_frame4(trg, cam, mats.color,
                                 cache=(tok, "shadow"), **KW)
    assert torch.equal(img, img2) and torch.equal(fl, fl2)
    nsx, nsy, _ = _sb_dims(80 // 16, 40 // 8)
    assert tuple(tok.shape) == (nsx * nsy, 2, 128)
    assert tok.dtype == torch.int32 and bool((tok == -1).all())
    assert shadow_tok is None
    _, (_, passed) = t4.render_frame4(
        trg, cam, mats.color, cache=(tok, "shadow"), return_cache=True,
        **{**KW, "with_flags": False})
    assert passed == "shadow"


def test_unported_modes_raise(world):
    """What the port still refuses: the retry knobs of the split path
    (they come with ``_bounce_retry4``, ROADMAP queue 1 item 10) and a
    ``prepared`` token whose tables do not fit together."""
    _, trg, mats, _ = world
    cam = CamData.create(CAMS[0][0], CAMS[0][1], 70.0, SIZE)
    with pytest.raises(TypeError, match="compact_tiles"):
        t4.render_frame4(trg, cam, mats.color, compact_tiles=64,
                         **{**KW, "fused": False})
    prep = t4.prepare_grid4(trg)
    for bad in (prep._replace(sw_cont=prep.sw_cont[:-1]),
                prep._replace(wmeta_pad=torch.cat([prep.wmeta_pad] * 2))):
        with pytest.raises(ValueError, match="cube|subwindows"):
            t4.render_frame4(trg, cam, mats.color, prepared=bad, **KW)
