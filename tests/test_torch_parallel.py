"""The port's band-sharded rendering (``parallel/render.py``) on a mesh of
eight CPU devices, the counterpart of tests/test_parallel.py's eight
virtual CPU devices, and the band offset of the camera rays against the
JAX package.

Bars, each with its reason:
  * the sharded SVO frame, the v3 band frames and the v4 band frames
    (with and without shadows) equal the port's unsharded frame word for
    word: a band's rays are the full frame's rows, and every ray marches
    alone;
  * the accumulated frame within 1e-6 of the host average of the
    per-sample frames (the sum of two samples and its halving are exact;
    the host cameras' eye is offset in float64 before it is rounded);
  * the plain band path (the rows y0 = 8 and 16 of a 32-row frame) against
    JAX's ``_render_frame`` and ``_render_frame4`` given the same
    ``full_height`` and ``y0``: the scalar row and the band's ray
    directions word for word (JAX's rays under ``jax.disable_jit()``: XLA
    contracts ``a*b+c`` under ``jit``), flags and packed words of the band
    frames exactly equal, where the JAX frames run their Pallas kernels in
    interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelraytracing_tpu.ops import noise as j_noise
from voxelraytracing_tpu.ops import wavefront3 as j3
from voxelraytracing_tpu.ops import wavefront4 as j4
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.world.demo import demo_chunk_grids_host

from voxelraytracing_tpu_torch.convert import render_grid3_from_numpy
from voxelraytracing_tpu_torch.models import RayTracer, RenderSettings
from voxelraytracing_tpu_torch.ops import noise
from voxelraytracing_tpu_torch.ops import wavefront3 as t3
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.ops.camera import CamData
from voxelraytracing_tpu_torch.ops.svo_build import build_chunk_svo_batch
from voxelraytracing_tpu_torch.parallel import (
    ShardedRayTracer, make_mesh, sharded_accumulate_step,
    sharded_render_frame3, sharded_render_frame4)
from voxelraytracing_tpu_torch.world.assemble import assemble_world_slice
from voxelraytracing_tpu_torch.world.demo import (
    demo_chunk_grids, demo_materials)

from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

CPU8 = ["cpu"] * 8
EYE = (32.0, 40.0, 32.0)
ROT = (30.0, 45.0, 0.0)
SUN = (100.0, 300.0, 50.0)
BAND = 8        # rows of the band held to JAX
FULL = (64, 32)  # its frame
BAND_ROT = (55.0, 45.0, 0.0)  # both bands hold sky and terrain


@pytest.fixture(scope="module")
def scene():
    """tests/test_parallel.py's 2-chunk demo world as an SVO slice (built
    on the CPU) and as RenderGrid3 tables: the port's, and JAX's from the
    same host build."""
    w = 2
    perm = torch.from_numpy(noise.make_permutation(7))
    grids, cells = demo_chunk_grids(
        perm, np.zeros(3, np.int32), w, float(w * 32 * 0.45),
        int(w * 32 * 0.28), device="cpu")
    nodes, _ = build_chunk_svo_batch(grids, device="cpu")
    world = assemble_world_slice(nodes, cells, np.zeros(3, np.int32), w,
                                 device="cpu")
    mats = demo_materials()
    hg, hc = demo_chunk_grids_host(
        j_noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    jrg = j3.build_render_grid3_host(hg, hc, np.zeros(3, np.int32), w, mats)
    trg = render_grid3_from_numpy(
        *[np.asarray(getattr(jrg, f)) for f in t3.RenderGrid3._fields],
        device="cpu")
    return world, mats, trg, jrg


def test_make_mesh_shapes():
    mesh = make_mesh(n_samples=2, n_rays=4, devices=CPU8)
    assert mesh.shape == {"samples": 2, "rays": 4}
    assert mesh.axis_names == ("samples", "rays")
    assert mesh.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in mesh.devices.reshape(-1))
    mesh1 = make_mesh(devices=CPU8)  # every device on the rays axis
    assert mesh1.shape == {"samples": 1, "rays": 8}
    with pytest.raises(ValueError):
        make_mesh(n_samples=3, n_rays=3, devices=CPU8)
    if not torch.cuda.is_available():  # the default mesh is every card
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()


def test_sharded_tracer_matches_unsharded(scene):
    world, mats, _, _ = scene
    cam = CamData.create(ROT, (32.0, 42.0, 32.0), 70.0, (32, 32))
    s = RenderSettings(sun_pos=SUN)
    ref_img, _ = RayTracer(mats).render(world, cam, s)
    mesh = make_mesh(n_samples=1, n_rays=8, devices=CPU8)
    sh_img = ShardedRayTracer(mats, mesh).render(world, cam, s)
    assert sh_img.shape == ref_img.shape == (32, 32, 3)
    np.testing.assert_array_equal(sh_img.numpy().view(np.int32),
                                  ref_img.numpy().view(np.int32))


def test_accumulate_step_matches_host_average(scene):
    world, mats, _, _ = scene
    n_samples, n_rays = 2, 4
    width, band_height = 32, 8
    full_h = band_height * n_rays
    mesh = make_mesh(n_samples=n_samples, n_rays=n_rays, devices=CPU8)
    cam = CamData.create(ROT, (32.0, 42.0, 32.0), 70.0, (width, full_h))
    jitter = 0.05
    step = sharded_accumulate_step(mesh, mats, width=width,
                                   band_height=band_height, max_steps=64)
    acc = step(world.nodes, world.chunk_roots, world.world_min,
               cam.inv_view, cam.inv_proj, cam.pos, np.float32(jitter))
    assert acc.shape == (full_h, width, 3) and acc.dtype == torch.float32

    tracer = RayTracer(mats, max_steps=64)
    frames = []
    for sid in range(n_samples):
        eps = (sid / n_samples) * jitter
        cam_s = CamData.create(ROT, (32.0 + eps, 42.0 + eps, 32.0 + eps),
                               70.0, (width, full_h))
        img, _ = tracer.render(world, cam_s, RenderSettings())
        frames.append(img.numpy())
    expect = np.stack(frames).mean(axis=0)
    np.testing.assert_allclose(acc.numpy(), expect, atol=1e-6, rtol=0)
    assert not np.array_equal(frames[0], frames[1])  # the jitter moved it


def test_sharded_render_frame3_matches_single_device(scene):
    """Band-sharded v3 frame == the single-device v3 frame (converged). A
    shadowed band equals the whole frame's rows in
    tests/test_torch_march3_host.py."""
    _, mats, trg, _ = scene
    cam = CamData.create(ROT, EYE, 70.0, (64, 64))
    s = RenderSettings(sun_pos=SUN)
    ref = t3.render_frame3(trg, cam, mats.color, rounds=32, sun_pos=SUN)
    mesh = make_mesh(n_samples=1, n_rays=8, devices=CPU8)
    got = sharded_render_frame3(mesh, trg, cam, mats.color, s, rounds=32)
    assert got.shape == ref.shape == (64, 64)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("shadows", [False, True])
def test_sharded_render_frame4_matches_single_device(scene, shadows):
    """Band-sharded v4 frame == the single-device split v4 frame."""
    _, mats, trg, _ = scene
    cam = CamData.create(ROT, EYE, 70.0, (64, 64))
    s = RenderSettings(sun_pos=SUN, shadows=shadows)
    ref = t4.render_frame4(trg, cam, mats.color, rounds=64, shadows=shadows,
                           sun_pos=SUN)
    mesh = make_mesh(n_samples=1, n_rays=8, devices=CPU8)
    got = sharded_render_frame4(mesh, trg, cam, mats.color, s)
    assert got.shape == ref.shape == (64, 64)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_band_asserts_whole_tiles(scene):
    """JAX's assert: a band is whole 8-row tiles."""
    _, mats, trg, _ = scene
    cam = CamData.create(ROT, EYE, 70.0, (64, 48))
    mesh = make_mesh(n_samples=1, n_rays=4, devices=CPU8)
    for fn in (sharded_render_frame3, sharded_render_frame4):
        with pytest.raises(AssertionError):
            fn(mesh, trg, cam, mats.color)


def _jax_args(jrg, jcam):
    wm = jnp.asarray(jrg.world_min, jnp.float32)
    origin = jnp.asarray(jcam.pos, jnp.float32) - wm
    return (origin, jnp.asarray(jcam.inv_view, jnp.float32),
            jnp.asarray(jcam.inv_proj, jnp.float32))


@pytest.fixture(scope="module")
def jax_bands(scene):
    """JAX's band frames (``_render_frame``, ``_render_frame4``) at y0 = 8
    and 16 of the 64x32 frame, unshadowed (a shadowed pair compiles in 26
    s, this in 17 s); each program compiles once (its ``y0`` is
    traced)."""
    _, mats, _, jrg = scene
    jcam = JCamData.create(BAND_ROT, EYE, 70.0, FULL)
    origin, iv, ip = _jax_args(jrg, jcam)
    lut = j3.color_lut_rows(mats.color)
    sun = jnp.asarray(SUN, jnp.float32) - jnp.asarray(jrg.world_min,
                                                      jnp.float32)
    common = (lut, jnp.asarray((0.81, 0.93, 1.0), jnp.float32), sun,
              jnp.float32(4.0), jnp.float32(0.4))
    tabs = (jrg.gw_jump, jrg.gw_liq, jrg.wmeta, jrg.sw_meta, jrg.sw_solid,
            jrg.sw_liq, jrg.sw_pid)
    kw = dict(width=FULL[0], height=BAND, sub_rounds=16, sub_steps=8,
              v=int(jrg.size_voxels), interpret=True, shadows=False,
              show_steps=False, full_height=FULL[1])
    out = {}
    for y0 in (8, 16):
        out["v3", y0] = j3._render_frame(
            *tabs, jrg.brick_dir, jrg.bricks, jrg.to_pack, origin, iv, ip,
            *common, rounds=32, y0=jnp.float32(y0), **kw)
        out["v4", y0] = j4._render_frame4(
            *tabs, origin, iv, ip, *common, rounds=64, y0=jnp.float32(y0),
            **kw)
    return {k: tuple(np.asarray(x) for x in v) for k, v in out.items()}


@pytest.mark.parametrize("y0", [8, 16])
def test_band_rays_match_jax(scene, y0):
    """The band's scalar row and the v3/v4 ray directions of its pixels
    equal JAX's (``_cam_scal`` and ``_ray_dirs`` of the band, without
    jit) word for word, and equal the full frame's rows."""
    _, _, trg, jrg = scene
    cam = CamData.create(BAND_ROT, EYE, 70.0, FULL)
    jcam = JCamData.create(BAND_ROT, EYE, 70.0, FULL)
    origin = np.asarray(cam.pos, np.float32)
    v = int(trg.size_voxels)
    row = t3._cam_scal(origin, cam.inv_view, cam.inv_proj, v, FULL[0],
                       FULL[1], float(y0))
    with jax.disable_jit():
        jrow = np.asarray(j3._cam_scal(*_jax_args(jrg, jcam), v, FULL[0],
                                       FULL[1], jnp.float32(y0)))
        nsx = j3._sb_dims(FULL[0] // 16, BAND // 8)[0]
        ti = jnp.broadcast_to(jnp.arange(64, dtype=jnp.int32)[:, None],
                              (64, 128))
        li = jnp.broadcast_to(jnp.arange(128, dtype=jnp.int32)[None, :],
                              (64, 128))
        jd = [np.asarray(d) for d in j3._ray_dirs(
            [jnp.asarray(jrow)[i] for i in range(24)], ti, li, nsx)]
    np.testing.assert_array_equal(row[:24].view(np.int32),
                                  jrow[:24].view(np.int32))
    ti = torch.arange(64, dtype=torch.int32)[:, None].expand(64, 128)
    li = torch.arange(128, dtype=torch.int32)[None, :].expand(64, 128)
    td = t3._ray_dirs([float(x) for x in row], ti, li, nsx)
    for a, b in zip(td, jd):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      b.view(np.int32))
    # the v4 camera rays of the band: the full frame's rows y0 .. y0+8
    sf = [float(x) for x in row]
    pxi, pyi = t4._pixels(BAND, FULL[0], "cpu")
    band = t4._camera_rays(sf, pxi, pyi)[3:]
    full_row = [float(x) for x in t3._cam_scal(
        origin, cam.inv_view, cam.inv_proj, v, FULL[0], FULL[1], 0.0)]
    pxf, pyf = t4._pixels(FULL[1], FULL[0], "cpu")
    full = t4._camera_rays(full_row, pxf, pyf)[3:]
    for a, b in zip(band, full):
        np.testing.assert_array_equal(
            a.numpy(), b.reshape(FULL[1], FULL[0])[y0:y0 + BAND].reshape(-1)
            .numpy())


@pytest.mark.parametrize("y0", [8, 16])
@pytest.mark.parametrize("tracer", ["v3", "v4"])
def test_band_frame_matches_jax(scene, jax_bands, tracer, y0):
    """The port's band frame (the rows y0 .. y0+8 of a 64x32 frame)
    equals JAX's band frame: flags and packed words exactly."""
    _, mats, trg, _ = scene
    cam = CamData.create(BAND_ROT, EYE, 70.0, FULL)
    settings = dict(sky_color=(0.81, 0.93, 1.0), sun_pos=SUN,
                    sun_intensity=4.0, shadow_ambient=0.4)
    if tracer == "v3":
        origin, lut, row = t3._frame_row3(trg, cam, mats.color, y0=y0,
                                          **settings)
        img, fl, _ = t3._render_frame(
            trg, origin, cam, lut, row, rounds=32, sub_rounds=16,
            step_cap=None, shadows=False, show_steps=False, cache_p=None,
            cache_s=None, compact=True, y0=y0, band_height=BAND)
    else:
        row, args, kw = t4._frame_inputs(
            trg, cam, mats.color, show_steps=False, shadows=False, rounds=64,
            steps_per_round=128, step_cap=None, prepared=None, y0=y0,
            band_height=BAND, **settings)
        img, fl = t4._render_frame4(row, *args, **kw)
    jimg, jfl = jax_bands[tracer, y0]
    assert img.shape == fl.shape == jimg.shape == (BAND, FULL[0])
    assert ((jfl >> 1) & 1).any() and not ((jfl >> 1) & 1).all()
    np.testing.assert_array_equal(fl.numpy(), jfl)
    np.testing.assert_array_equal(img.numpy().view(np.uint32), jimg)
