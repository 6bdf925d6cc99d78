"""Camera, ray directions and frame layout of the PyTorch port against
the JAX package.

Directions are held bit for bit. The JAX reference runs op by op, as
its source is written, as under ``jax.disable_jit()``: its program
evaluated one primitive at a time in NumPy
(``tests/jax_op_by_op.py:numpy_op_by_op``), which rounds alike without
compiling each primitive for each frame size. Inside one
jitted program XLA's CPU compiler contracts ``a*b+c`` into FMAs, which
moves a share of the directions by an ulp; the port and its CUDA kernel
round each multiply and add on its own, as the source reads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelraytracing_tpu.ops import camera as j_camera
from voxelraytracing_tpu.ops import wavefront3 as j3
from voxelraytracing_tpu_torch.ops import camera
from voxelraytracing_tpu_torch.ops import wavefront3 as t3
from jax_op_by_op import numpy_op_by_op
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

CAMS = [
    ((30.0, 45.0, 0.0), (64.0, 75.0, 64.0), (64, 32)),
    ((5.0, 120.0, 0.0), (20.0, 40.0, 100.0), (72, 36)),
    ((60.0, 200.0, 7.0), (100.0, 110.0, 30.0), (131, 67)),
    ((-20.0, 300.0, 0.0), (64.0, 20.0, 64.0), (320, 180)),
    ((89.0, 0.0, 0.0), (1e4, -3e3, 5.5), (17, 9)),
]


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("rot,eye,size", CAMS)
def test_camdata_equal(rot, eye, size):
    a = camera.CamData.create(rot, eye, 70.0, size)
    b = j_camera.CamData.create(rot, eye, 70.0, size)
    for f in ("pos", "inv_view", "inv_proj"):
        np.testing.assert_array_equal(bits(getattr(a, f)), bits(getattr(b, f)))
    assert a.proj_size == b.proj_size


@pytest.mark.parametrize("rot,eye,size", CAMS)
def test_generate_rays_bit_equal(rot, eye, size):
    wmin = np.array([3, -2, 40], np.int32)
    cam = camera.CamData.create(rot, eye, 70.0, size)
    o, d = camera.generate_rays(cam, wmin, device="cpu")
    jc = j_camera.CamData.create(rot, eye, 70.0, size)
    jo, jd = numpy_op_by_op(lambda: j_camera.generate_rays(jc, wmin))()
    assert tuple(d.shape) == (size[1], size[0], 3) and d.dtype == torch.float32
    np.testing.assert_array_equal(bits(o.numpy()), bits(jo))
    np.testing.assert_array_equal(bits(d.numpy()), bits(jd))


def test_generate_rays_band():
    """A horizontal band of a taller frame (the sharded-render form)."""
    cam = camera.CamData.create((10.0, 30.0, 0.0), (5.0, 6.0, 7.0), 60.0,
                                (48, 16))
    args = (cam.inv_view, cam.inv_proj, cam.pos, 48, 16, np.zeros(3))
    _, d = camera.generate_rays_raw(*args, y0=32, full_height=64,
                                    device="cpu")
    _, jd = numpy_op_by_op(lambda: j_camera.generate_rays_raw(
        *args, y0=32, full_height=64))()
    np.testing.assert_array_equal(bits(d.numpy()), bits(jd))


def test_sqrt_rn_is_correctly_rounded():
    """torch.sqrt on CPU misses IEEE rounding for some inputs; the port's
    sqrt must not (the kernels use IEEE sqrtf)."""
    x = np.random.default_rng(1).random(200_000).astype(np.float32) * 30
    np.testing.assert_array_equal(
        bits(camera.sqrt_rn(torch.from_numpy(x)).numpy()),
        bits(np.sqrt(x.astype(np.float64)).astype(np.float32)))


@pytest.mark.parametrize("rot,eye,size", CAMS[:4])
def test_cam_scal_and_ray_dirs_bit_equal(rot, eye, size):
    """The kernel's scalar row and per-pixel directions (the JAX kernel's
    ``_ray_dirs``, evaluated op by op)."""
    cam = camera.CamData.create(rot, eye, 70.0, size)
    w, h = size
    origin = cam.pos - np.float32(2.0)
    scal = t3._cam_scal(origin, cam.inv_view, cam.inv_proj, 128, w, h, 0.0)
    jscal = j3._cam_scal(jnp.asarray(origin), jnp.asarray(cam.inv_view),
                         jnp.asarray(cam.inv_proj), 128, w, h, 0.0)
    np.testing.assert_array_equal(bits(scal), bits(jscal))
    tx, ty = w // 16, h // 8
    nsx, _, T = t3._sb_dims(tx, ty)
    tg = torch.arange(T, dtype=torch.int32)[:, None].expand(T, 128)
    lane = torch.arange(128, dtype=torch.int32)[None, :].expand(T, 128)
    jd = numpy_op_by_op(lambda: j3._ray_dirs(
        [jscal[i] for i in range(24)], jnp.asarray(tg.numpy()),
        jnp.asarray(lane.numpy()), nsx))()
    for a, b in zip(t3._ray_dirs(scal, tg, lane, nsx), jd):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b))


@pytest.mark.parametrize("w,h", [(64, 32), (72, 36), (1920, 1080)])
def test_tile_layout_equal(w, h):
    tx, ty = w // 16, h // 8
    assert t3._sb_dims(tx, ty) == j3._sb_dims(tx, ty)
    _, _, T = t3._sb_dims(tx, ty)
    img = np.random.default_rng(w).integers(
        -2**31, 2**31, (ty * 8, tx * 16, 3), dtype=np.int64).astype(np.int32)
    tiles = t3._tile_hw(torch.from_numpy(img), tx, ty, T)
    np.testing.assert_array_equal(tiles.numpy(),
                                  np.asarray(j3._tile_hw(img, tx, ty, T)))
    back = t3._untile_hw(tiles, tx, ty, w, h)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j3._untile_hw(jnp.asarray(tiles.numpy()),
                                               tx, ty, w, h)))
    valid = t3._tile_valid(tx, ty, T, tiles.device)
    assert valid.device == tiles.device
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(j3._tile_valid(tx, ty, T)))


def test_unpack_rgba8_equal():
    words = np.random.default_rng(2).integers(
        0, 2**32, (9, 13), dtype=np.uint64).astype(np.uint32)
    a = t3.unpack_rgba8(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(a, j3.unpack_rgba8(words))
    assert (t3._FL_HIT, t3._FL_AX, t3._FL_STP, t3._FL_VOX, t3._FL_SGN) == (
        j3._FL_HIT, j3._FL_AX, j3._FL_STP, j3._FL_VOX, j3._FL_SGN)
