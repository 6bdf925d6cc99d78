"""The port's shadowed v4 frame, fused and split, against the JAX package.

One 4-chunk demo world, built by the JAX package's host build and carried over
with ``convert.render_grid3_from_numpy``, feeds both packages. The JAX
golden of each camera is ``render_frame4(fused=True, shadows=True)``, its
Pallas kernel run in interpret mode on the CPU; the JAX tests pin its
split path to the same frame (tests/test_wavefront4.py:506), so one
golden holds both of the port's paths, which run their plain PyTorch
versions on CPU tensors.

Tolerances: flags and every hit pixel's packed word exactly equal (the
shadow bit of every hit included: the port rebuilds each shadow ray in the
JAX op order, and no knife-edge shadow bit flips on these cameras); a sky
channel within 1/255, because the two libms may round ``** 0.35``
differently.
"""

import numpy as np
import pytest
import torch

from voxelraytracing_tpu.ops import noise as j_noise
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.ops.wavefront3 import build_render_grid3_host
from voxelraytracing_tpu.ops.wavefront4 import render_frame4 as j_render_frame4
from voxelraytracing_tpu.world.demo import demo_chunk_grids_host, demo_materials
from voxelraytracing_tpu_torch.convert import render_grid3_from_numpy
from voxelraytracing_tpu_torch.ops import wavefront3 as t3
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.ops.camera import CamData
from torch_nan_camera import NAN_SKY, zero_basis
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

# test_wavefront4.py:44-49
CAMS = [
    ((30.0, 45.0, 0.0), (64.0, 75.0, 64.0)),
    ((5.0, 120.0, 0.0), (20.0, 40.0, 100.0)),
    ((60.0, 200.0, 0.0), (100.0, 110.0, 30.0)),
    ((-20.0, 300.0, 0.0), (64.0, 20.0, 64.0)),  # underwater, looking up
]
SHADOW_CAMS = (0, 1, 3)
KW = dict(sun_pos=(1000.0, 2500.0, 500.0), step_cap=500, rounds=64,
          with_flags=True, shadows=True)
SIZE = (64, 32)


def _jax_frame(jrg, colors, cam_cfg, **kw):
    cam = JCamData.create(cam_cfg[0], cam_cfg[1], 70.0, SIZE)
    img, fl = j_render_frame4(jrg, cam, colors, fused=True, **{**KW, **kw})
    return np.asarray(img), np.asarray(fl)


@pytest.fixture(scope="module")
def world():
    """Both packages' worlds and the JAX goldens: the fused-shadow program
    compiles once for the whole file (the step cap is traced)."""
    w = 4
    grids, cells = demo_chunk_grids_host(
        j_noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    mats = demo_materials()
    jrg = build_render_grid3_host(grids, cells, np.zeros(3, np.int32), w, mats)
    trg = render_grid3_from_numpy(
        *[np.asarray(getattr(jrg, f)) for f in t3.RenderGrid3._fields],
        device="cpu")
    gold = {i: _jax_frame(jrg, mats.color, CAMS[i]) for i in SHADOW_CAMS}
    gold["cap20"] = _jax_frame(jrg, mats.color, CAMS[0], step_cap=20)
    nan_cam = zero_basis(JCamData.create(*CAMS[0], 70.0, SIZE))
    for fused in (True, False):
        gold["nan", fused] = tuple(np.asarray(x) for x in j_render_frame4(
            jrg, nan_cam, mats.color, fused=fused, **KW))
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


@pytest.mark.parametrize("i", SHADOW_CAMS)
def test_fused_shadow_frame_matches_jax(world, i):
    trg, mats, gold = world
    port = _port_frame(trg, mats.color, CAMS[i], fused=True)
    assert_frames_match(port, gold[i])
    assert ((port[1] >> 1) & 1).any()


@pytest.mark.parametrize("i", SHADOW_CAMS)
def test_split_shadow_frame_matches_jax(world, i):
    trg, mats, gold = world
    assert_frames_match(_port_frame(trg, mats.color, CAMS[i], fused=False),
                        gold[i])


@pytest.mark.parametrize("fused", [True, False])
def test_shadow_frame_nan_direction_matches_jax(world, fused):
    """A camera with no basis: every direction NaN, no primary hit, so no
    shadow ray; JAX's packed words (a NaN sky is byte 0) and flags
    exactly, fused and split (whose blocks pass zero planes through)."""
    trg, mats, gold = world
    img, fl = t4.render_frame4(
        trg, zero_basis(CamData.create(*CAMS[0], 70.0, SIZE)), mats.color,
        fused=fused, **KW)
    jimg, jfl = gold["nan", fused]
    assert (jimg.view(np.uint32) == NAN_SKY).all()
    assert (jfl == (0 if fused else t4._FL_ZERO)).all()
    np.testing.assert_array_equal(img.numpy().view(np.uint32), jimg)
    np.testing.assert_array_equal(fl.numpy(), jfl)


def test_shadows_darken_some_hits(world):
    """The shadow leg does something: on cam 0 some hit pixels are darker
    with shadows than without, and no pixel is brighter."""
    trg, mats, _ = world
    lit, fl = _port_frame(trg, mats.color, CAMS[0], fused=True,
                          shadows=False)
    shaded, _ = _port_frame(trg, mats.color, CAMS[0], fused=True)
    hit = ((fl >> 1) & 1) != 0
    darker = np.zeros_like(hit)
    for sh in (0, 8, 16):
        a, b = (lit >> sh) & 255, (shaded >> sh) & 255
        assert (b <= a).all()
        darker |= b < a
    assert darker[hit].any() and not darker[~hit].any()


@pytest.mark.parametrize("i", range(len(CAMS)))
def test_split_equals_fused(world, i):
    """The port's split frame equals its fused frame word for word, flags
    too, with and without shadows (both shade through one epilogue)."""
    trg, mats, _ = world
    for shadows in (False, True):
        a = _port_frame(trg, mats.color, CAMS[i], fused=True, shadows=shadows)
        b = _port_frame(trg, mats.color, CAMS[i], fused=False,
                        shadows=shadows)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("fused", [True, False])
def test_shadow_step_cap(world, fused):
    """``step_cap=20`` caps both legs; the shadow leg's steps never reach
    the flags."""
    trg, mats, gold = world
    port = _port_frame(trg, mats.color, CAMS[0], step_cap=20, fused=fused)
    assert_frames_match(port, gold["cap20"])
    assert ((port[1] >> 5) & 0xFFF).max() == 20
