"""The port's split v4 path and state-plane march against the JAX package:
the unshadowed split frame, ``trace_wavefront4_rays`` and the split shade.

One 4-chunk demo world, built by the JAX package's host build and carried over
with ``convert.render_grid3_from_numpy``, feeds both packages. The JAX
side runs as the JAX tests run it on the CPU (Pallas in interpret mode);
the port runs its plain PyTorch versions on CPU tensors. Inputs are made
from fixed numpy seeds and handed to both.

Tolerances, each with its reason:
  * flags, hits, voxel ids, step counts and every hit pixel's packed word
    exactly equal;
  * a sky channel within 1/255: the two libms may round ``** 0.35``
    differently;
  * ``t`` within 2e-6 relative and the water length within 1e-4
    absolute: XLA contracts ``a*b+c`` into FMAs inside the interpret-mode
    kernel (positions, DDA exits), which moves ``t`` by a few ulps, and
    the water length is a difference of two such ``t`` (measured <= 6.2e-7
    and <= 4.6e-5 on camera rays at 64x32).
"""

import numpy as np
import pytest
import torch

from voxelraytracing_tpu.ops import noise as j_noise
from voxelraytracing_tpu.ops import wavefront3 as j3
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.ops.wavefront4 import render_frame4 as j_render_frame4
from voxelraytracing_tpu.ops.wavefront4 import (
    trace_wavefront4_rays as j_trace_rays,
)
from voxelraytracing_tpu.world.demo import demo_chunk_grids_host, demo_materials
from voxelraytracing_tpu_torch.convert import render_grid3_from_numpy
from voxelraytracing_tpu_torch.ops import camera as t_camera
from voxelraytracing_tpu_torch.ops import wavefront3 as t3
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.ops.camera import CamData
from torch_nan_camera import NAN_SKY, zero_basis
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

CAMS = [
    ((30.0, 45.0, 0.0), (64.0, 75.0, 64.0)),
    ((5.0, 120.0, 0.0), (20.0, 40.0, 100.0)),
    ((60.0, 200.0, 0.0), (100.0, 110.0, 30.0)),
    ((-20.0, 300.0, 0.0), (64.0, 20.0, 64.0)),  # underwater, looking up
    ((30.0, 45.0, 0.0), (-50.0, 75.0, 64.0)),   # outside the world
]
KW = dict(sun_pos=(1000.0, 2500.0, 500.0), step_cap=500, rounds=64,
          with_flags=True, fused=False)
SIZE = (64, 32)
SUN = np.array([1000.0, 2500.0, 500.0], np.float32)
# two 128x64-pixel superblocks side by side (a 128-wide frame whose height
# is a multiple of 64 has the [T,128,3] shape of a pre-tiled bundle, which
# the JAX trace_wavefront4_rays reads as tiles)
BIG = (256, 64)
# origins outside the world, behind rays that head away from it
OUTSIDE_X, OUTSIDE_Z = (-50.0, 75.0, 64.0), (64.0, 75.0, -50.0)


def _shadow_bundle(trg):
    """The shadow bundle of tests/test_wavefront4.py:96-116, built with
    numpy from the port's primary march: hit points nudged along the
    normal, unit directions to the sun, active where the primary hit. At
    :data:`BIG`, as the other bundle, so one JAX program traces both."""
    cam = CamData.create(CAMS[0][0], CAMS[0][1], 70.0, BIG)
    origin, dirs = t_camera.generate_rays(cam, np.zeros(3, np.int32),
                                          device="cpu")
    p = t4.trace_wavefront4(trg, origin.numpy(), cam=cam, step_cap=500)
    hit = p.hit.numpy()
    hitp = origin.numpy()[None, None] + dirs.numpy() * p.t.numpy()[..., None]
    sd = SUN[None, None] - hitp
    sd /= np.linalg.norm(sd, axis=-1, keepdims=True)
    so = (hitp + p.norm.numpy() * 1e-3).astype(np.float32)
    return so, sd.astype(np.float32), hit


def _half_bundle():
    """CAMS[0]'s camera rays on a 256x64 frame (two 128x64-pixel
    superblocks), a random tenth of them inactive. Every ray of the left
    superblock and of the last 16 columns starts outside the world,
    heading away from it (``dx < 0`` on the left, ``dz < 0`` on the
    right), so none of them is active and their slab exits are negative:
    the JAX kernel passes the left superblock's start state through and
    marches the right one."""
    cam = CamData.create(CAMS[0][0], CAMS[0][1], 70.0, BIG)
    origin, dirs = t_camera.generate_rays(cam, np.zeros(3, np.int32),
                                          device="cpu")
    o = np.broadcast_to(origin.numpy(), BIG[::-1] + (3,)).copy()
    o[:, :128] = OUTSIDE_X
    o[:, -16:] = OUTSIDE_Z
    active = np.random.default_rng(11).random(BIG[::-1]) < 0.9
    return o, dirs.numpy(), active


@pytest.fixture(scope="module")
def world():
    """Both packages' worlds and the JAX goldens: the split frame (one
    program for the five cameras) and the per-ray traces."""
    w = 4
    grids, cells = demo_chunk_grids_host(
        j_noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    mats = demo_materials()
    jrg = j3.build_render_grid3_host(grids, cells, np.zeros(3, np.int32), w,
                                     mats)
    trg = render_grid3_from_numpy(
        *[np.asarray(getattr(jrg, f)) for f in t3.RenderGrid3._fields],
        device="cpu")
    gold = {}
    for i, (rot, eye) in enumerate(CAMS):
        img, fl = j_render_frame4(
            jrg, JCamData.create(rot, eye, 70.0, SIZE), mats.color, **KW)
        gold[i] = np.asarray(img), np.asarray(fl)
    gold["nan"] = tuple(np.asarray(x) for x in j_render_frame4(
        jrg, zero_basis(JCamData.create(*CAMS[0], 70.0, SIZE)), mats.color,
        **KW))
    gold["bundle"] = _shadow_bundle(trg)
    gold["rays"] = j_trace_rays(jrg, *gold["bundle"], width=BIG[0],
                                height=BIG[1], rounds=64, step_cap=500)
    gold["half"] = _half_bundle()
    gold["half_rays"] = j_trace_rays(jrg, *gold["half"], width=BIG[0],
                                     height=BIG[1], rounds=64)
    return trg, mats, gold


def _port_frame(trg, colors, cam_cfg, **kw):
    cam = CamData.create(cam_cfg[0], cam_cfg[1], 70.0, SIZE)
    img, fl = t4.render_frame4(trg, cam, colors, **{**KW, **kw})
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


def assert_results_match(res, ref):
    """WavefrontResult of the port against JAX's, under the module's
    tolerances."""
    hit = res.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    np.testing.assert_array_equal(res.voxel.numpy(), np.asarray(ref.voxel))
    np.testing.assert_array_equal(res.steps.numpy(), np.asarray(ref.steps))
    np.testing.assert_array_equal(res.norm.numpy(), np.asarray(ref.norm))
    np.testing.assert_allclose(res.t.numpy(), np.asarray(ref.t), rtol=2e-6,
                               atol=0)
    np.testing.assert_allclose(res.water_dist.numpy(),
                               np.asarray(ref.water_dist), rtol=0, atol=1e-4)


@pytest.mark.parametrize("i", range(len(CAMS)))
def test_split_frame_matches_jax(world, i):
    """The unshadowed split frame, flags included. For the camera outside
    the world no ray starts, so every block passes its zero state planes
    through, and the split shade draws them as JAX does: flags
    ``-0x30000000`` and, where the slab exit is negative, a water tint
    (the fused frame shades the fresh-start state instead)."""
    trg, mats, gold = world
    port = _port_frame(trg, mats.color, CAMS[i])
    assert_frames_match(port, gold[i])
    if i == 4:
        assert (port[1] == t4._FL_ZERO).all()


def test_split_frame_nan_direction_matches_jax(world):
    """A camera with no basis: no ray starts, so every block passes its
    zero planes through (flags ``-0x30000000``), and the split shade packs
    JAX's words (a NaN sky is byte 0) exactly."""
    trg, mats, gold = world
    img, fl = t4.render_frame4(
        trg, zero_basis(CamData.create(*CAMS[0], 70.0, SIZE)), mats.color,
        **KW)
    jimg, jfl = gold["nan"]
    assert (jimg.view(np.uint32) == NAN_SKY).all()
    assert (jfl == t4._FL_ZERO).all()
    np.testing.assert_array_equal(img.numpy().view(np.uint32), jimg)
    np.testing.assert_array_equal(fl.numpy(), jfl)


def test_trace_rays_shadow_bundle_matches_jax(world):
    """The per-ray march on the shadow bundle: inactive rays stay misses;
    hit, voxel and steps exact; ``t`` and water under the stated
    tolerances."""
    trg, _, gold = world
    so, sd, hit = gold["bundle"]
    res = t4.trace_wavefront4_rays(trg, so, sd, hit, width=BIG[0],
                                   height=BIG[1], step_cap=500)
    assert_results_match(res, gold["rays"])
    shadowed = res.hit.numpy()
    assert not shadowed[~hit].any()
    assert 0.0 < shadowed[hit].mean() < 0.5


def test_trace_rays_untouched_superblock_matches_jax(world):
    """Rays on a 256x64 frame whose left superblock has no active ray:
    there the JAX kernel passes the fresh start (``t = EPS_T``) through;
    in the right one it clamps every ``t`` to the slab exit, which is
    negative for an outside ray heading away from the world."""
    trg, _, gold = world
    o, d, active = gold["half"]
    res = t4.trace_wavefront4_rays(trg, o, d, active, width=BIG[0],
                                   height=BIG[1])
    assert_results_match(res, gold["half_rays"])
    t = res.t.numpy()
    assert (d[:, :128, 0] < 0).all()
    assert (t[:, :128] == np.float32(1e-3)).all()
    assert (t[:, -16:] < 0).all() and res.hit.numpy()[:, 128:].any()


def test_touched_marks_match_jax_starts(world):
    """The start marks (``touched4`` on CPU tensors: its plain version) of
    the 256x64 bundle mark exactly the 16x8 tiles in which a ray of the
    JAX trace took a step: none in the left superblock, whose start state
    JAX passes through, none in the last 16 columns, some in between."""
    trg, _, gold = world
    o, d, active = gold["half"]
    eye = np.eye(4, dtype=np.float32)
    scal = torch.from_numpy(t4._scal_row(trg, np.zeros(3, np.float32), eye,
                                         eye, BIG[0], BIG[1], None))
    marks = t4.touched4(scal, torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(active), height=BIG[1], width=BIG[0])
    assert marks.dtype == torch.uint8 and marks.shape == (8, 16)
    stepped = np.asarray(gold["half_rays"].steps) > 0
    tiles = stepped.reshape(8, 8, 16, 16).any(axis=(1, 3))
    np.testing.assert_array_equal(marks.numpy() != 0, tiles)
    assert not tiles[:, :8].any() and not tiles[:, -1].any()
    assert tiles[:, 8:].any()


def test_trace_rays_with_camera_rays_equal_trace(world):
    """trace_wavefront4_rays fed the camera's own rays == trace_wavefront4,
    as in tests/test_wavefront4.py:80-93: hits and voxel ids exact, ``t``
    within 1e-4 (``generate_rays`` and the march's camera directions
    round in different op orders)."""
    trg, _, _ = world
    cam = CamData.create(CAMS[0][0], CAMS[0][1], 70.0, SIZE)
    origin, dirs = t_camera.generate_rays(cam, np.zeros(3, np.int32),
                                          device="cpu")
    p = t4.trace_wavefront4(trg, origin.numpy(), cam=cam)
    r = t4.trace_wavefront4_rays(trg, origin.expand(32, 64, 3), dirs,
                                 torch.ones(32, 64, dtype=torch.bool),
                                 width=64, height=32)
    assert torch.equal(p.hit, r.hit) and p.hit.any()
    assert torch.equal(p.voxel, r.voxel)
    np.testing.assert_allclose(p.t.numpy(), r.t.numpy(), atol=1e-4)


def test_trace_asserts_tile_multiples(world):
    trg, _, _ = world
    o = np.full((30, 64, 3), 5.0, np.float32)
    with pytest.raises(ValueError, match="multiple"):
        t4.trace_wavefront4_rays(trg, o, o, np.ones((30, 64), bool),
                                 width=64, height=30)
    cam = CamData.create(CAMS[0][0], CAMS[0][1], 70.0, (72, 32))
    with pytest.raises(ValueError, match="multiple"):
        t4.trace_wavefront4(trg, np.zeros(3, np.float32), cam=cam)


def _random_planes(seed):
    """Random split-shade inputs in JAX's tile layout [64,128] (one
    superblock, 128x64 pixels): flag words with random hit, axis, step,
    voxel and sign bits; ``ts``; closed (``we = -1``) and open water
    intervals; a random shadow plane."""
    rng = np.random.default_rng(seed)
    shape = (64, 128)
    fl = ((rng.integers(0, 2, shape) << 1) | (rng.integers(0, 8, shape) << 2)
          | (rng.integers(0, 4096, shape) << 5)
          | (rng.integers(0, 256, shape) << 17)
          | (rng.integers(0, 8, shape) << 25)).astype(np.int32)
    ts = rng.uniform(0.0, 250.0, shape).astype(np.float32)
    wa = np.where(rng.random(shape) < 0.5, 0.0,
                  rng.uniform(0.0, 30.0, shape)).astype(np.float32)
    we = np.where(rng.random(shape) < 0.5, -1.0,
                  rng.uniform(0.0, 1.0, shape) * ts).astype(np.float32)
    sh = rng.integers(0, 2, shape).astype(np.int32)
    return ts, fl, wa, we, sh


@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("show_steps", [False, True])
def test_shade_plain_version_matches_jax_shade(world, shadows, show_steps):
    """shade4_ref against JAX ``wavefront3._shade`` on random planes:
    each pixel's direction and slab exit come from the camera row, the
    water interval closes at ``min(ts, t_exit)``."""
    trg = world[0]
    cam = CamData.create(CAMS[0][0], CAMS[0][1], 70.0, (128, 64))
    row = t4._split_shade_row(t4._frame_scal(
        trg, cam, sky_color=(0.81, 0.93, 1.0), sun_pos=(1000.0, 2500.0, 500.0),
        sun_intensity=4.0, shadow_ambient=0.3, step_cap=500, sub_rounds=16))
    lut = np.random.default_rng(5).random((6, 128)).astype(np.float32)
    planes = _random_planes(17 + 2 * shadows + show_steps)
    jimg = np.asarray(j3._shade(row, lut[None], *planes, nsx=1,
                                show_steps=show_steps, shadows=shadows,
                                max_steps=2048, interpret=True))
    jimg = t3._untile_hw(torch.from_numpy(jimg.view(np.int32).copy()), 8, 8,
                         128, 64)
    img = t4.shade4_ref(
        torch.from_numpy(row), torch.from_numpy(lut),
        *[t3._untile_hw(torch.from_numpy(p), 8, 8, 128, 64) for p in planes],
        show_steps=show_steps, shadows=shadows, max_steps=2048)
    fl = t3._untile_hw(torch.from_numpy(planes[1]), 8, 8, 128, 64).numpy()
    assert_frames_match((img.numpy().view(np.uint32), fl),
                        (jimg.numpy().view(np.uint32), fl))
