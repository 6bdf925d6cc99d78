"""The port's SVO renderers against the JAX package's: ``RayTracer``,
``composite_crosshair``, ``PathTracer`` and the normal draws it scatters
with.

Scene: the 4-chunk demo world of ``make_demo_world(7, 4)`` (both
packages' worlds equal word for word, tests/test_torch_world_slice.py),
test_wavefront4.py's first camera at 64x32, config2's sun.

Bars, each with its reason:
  * ``RayTracer`` (plain, shadowed at ``shadow_ambient`` 0.4 and 1.0, the
    step heatmap) and ``composite_crosshair`` (off, dot, cross) against
    JAX's program evaluated one primitive at a time, as under
    ``jax.disable_jit()`` (NumPy's ``tests/jax_op_by_op.py:numpy_op_by_op``,
    which test_torch_traverse.py holds to ``disable_jit`` on the tracer):
    the image and every TraceResult field word for word;
  * the normal draws: word for word against ``jax.random.normal`` (the
    bits are matched, so no statistical comparison is needed), and XLA's
    ``erf_inv`` on the values the uniform can take (a subset here; all
    2**23 agree);
  * ``PathTracer`` (2 bounces, 1 sample, two keys) against JAX's jitted
    tracer, compiled once: every pixel within 2/255 (the PT bar asks 99%)
    and every channel within 2e-6 absolute (measured 9.0e-7: ``exp``'s
    ulps and XLA's contracted multiply-adds; 88-89% of the words equal).
    Determinism, key sensitivity and the variance falling with samples run
    on the port only (JAX's own sample sweep is not repeated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelraytracing_tpu.models import pathtracer as jpt
from voxelraytracing_tpu.models import raytracer as jrt
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.world.demo import make_demo_world as j_make_demo_world

from voxelraytracing_tpu_torch.models import (
    PathTracer, RayTracer, RenderSettings, accumulate, composite_crosshair)
from voxelraytracing_tpu_torch.models import raytracer as trt
from voxelraytracing_tpu_torch.ops import prng
from voxelraytracing_tpu_torch.ops.camera import CamData
from voxelraytracing_tpu_torch.world.demo import demo_materials, make_demo_world

from jax_op_by_op import numpy_op_by_op
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

CPU = dict(device="cpu")
CAM = ((30.0, 45.0, 0.0), (64.0, 75.0, 64.0))
SUN = (1000.0, 2500.0, 500.0)
PT_ATOL = 2e-6


@pytest.fixture(scope="module")
def scene():
    return make_demo_world(7, 4, **CPU), j_make_demo_world(7, 4), demo_materials()


def _cams(size):
    return (CamData.create(CAM[0], CAM[1], 70.0, size),
            JCamData.create(CAM[0], CAM[1], 70.0, size))


def _words(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _equal(port, ref):
    np.testing.assert_array_equal(_words(port.numpy()), _words(ref))


@pytest.mark.parametrize("mode", ["plain", "shadows", "shadows_lit", "heatmap"])
def test_raytracer_equals_jax_without_jit(scene, mode):
    world, jworld, mats = scene
    kw = {"heatmap": dict(show_step_count=True)}.get(mode, {})
    skw = dict(sun_pos=SUN, shadows=mode.startswith("shadows"),
               shadow_ambient=1.0 if mode == "shadows_lit" else 0.4)
    cam, jcam = _cams((64, 32))
    img, rs = RayTracer(mats, **kw).render(world, cam, RenderSettings(**skw))
    jimg, jrs = numpy_op_by_op(lambda: jrt.RayTracer(mats, **kw).render(
        jworld, jcam, jrt.RenderSettings(**skw)))()
    assert img.shape == (32, 64, 3) and img.dtype == torch.float32
    _equal(img, jimg)
    for f in rs._fields:
        _equal(getattr(rs, f), getattr(jrs, f))
    if mode == "shadows":
        base, _ = RayTracer(mats).render(world, cam, RenderSettings(sun_pos=SUN))
        assert (img <= base).all() and (img < base - 1e-4).any()
        # the constructor's switch is the same pass as the settings'
        ctor, _ = RayTracer(mats, shadows=True).render(
            world, cam, RenderSettings(sun_pos=SUN))
        assert torch.equal(ctor, img)
    if mode == "shadows_lit":
        base, _ = RayTracer(mats).render(world, cam, RenderSettings(sun_pos=SUN))
        assert torch.equal(img, base)


@pytest.mark.parametrize("style", ["off", "dot", "cross"])
def test_composite_crosshair_equals_jax(scene, style):
    world, _, mats = scene
    cam, _ = _cams((64, 32))
    img, _ = RayTracer(mats).render(world, cam, RenderSettings(sun_pos=SUN))
    for kw in ({}, dict(size=5.0, color=(1.0, 0.2, 0.1, 0.5))):
        got = composite_crosshair(img, style, **kw)
        ref = numpy_op_by_op(lambda: jrt.composite_crosshair(
            jnp.asarray(img.numpy()), style, **kw))()
        _equal(got, ref)
    if style == "off":
        assert got is img
    else:
        assert not torch.equal(got, img)


def test_normal_draws_equal_jax_bits():
    """prng.normal == jax.random.normal word for word, on keys from split
    and fold_in as the path tracer derives them."""
    for seed, shape in ((0, (16, 32, 3)), (7, (5, 3)), (2**31 + 5, (999,))):
        key = jax.random.PRNGKey(seed)
        for k in (key, jax.random.fold_in(jax.random.split(key, 3)[2], 1)):
            want = np.asarray(jax.random.normal(k, shape, dtype=jnp.float32))
            got = prng.normal(np.asarray(jax.random.key_data(k)), shape, **CPU)
            _equal(got, want)


def test_erf_inv_on_the_uniform_values():
    """XLA's f32 erf_inv (log1p, the polynomial, the contracted multiply-
    adds) on the values the uniform of jax.random.normal takes: every 16th
    of its 2**23, and all of the 2**16 nearest each end of the interval
    (the polynomial's second branch). All 2**23 agree too; this subset
    keeps the test short."""
    n = 1 << 23
    k = np.unique(np.concatenate([np.arange(0, n, 16), np.arange(1 << 16),
                                  np.arange(n - (1 << 16), n)])
                  ).astype(np.uint32)
    fb = (k | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.maximum(lo, fb * np.float32(2.0) + lo)
    assert len(np.unique(u)) == len(k)
    _equal(prng.erf_inv_xla(torch.from_numpy(u)),
           np.asarray(jax.jit(jax.lax.erf_inv)(u)))


@pytest.fixture(scope="module")
def jax_pt(scene):
    """JAX's path tracer, compiled once for the module's frames."""
    _, _, mats = scene
    return jpt.PathTracer(mats, max_bounces=2)


@pytest.mark.parametrize("seed", [1, 2])
def test_pathtracer_matches_jax(scene, jax_pt, seed):
    world, jworld, mats = scene
    cam, jcam = _cams((32, 16))
    key = jax.random.PRNGKey(seed)
    s = RenderSettings(sun_pos=SUN)
    got = PathTracer(mats, max_bounces=2).render(
        world, cam, s, key=np.asarray(jax.random.key_data(key))).numpy()
    ref = np.asarray(jax_pt.render(jworld, jcam, jrt.RenderSettings(sun_pos=SUN),
                                   key=key))
    assert got.shape == ref.shape == (16, 32, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=PT_ATOL)

    def q(x):
        return (np.clip(x, 0, 1) * 255).astype(np.uint8).astype(int)

    assert (np.abs(q(got) - q(ref)) <= 2).all(axis=-1).mean() >= 0.99


def test_pathtracer_determinism_and_variance(scene):
    """Same key, same frame; another key, another frame; more samples move
    a frame closer to a many-sample reference (the port only)."""
    world, _, mats = scene
    cam, _ = _cams((32, 16))
    pt = PathTracer(mats, max_bounces=1, max_steps=64)
    s = RenderSettings(sun_pos=SUN)

    def key(i):
        return np.asarray([0, i], np.uint32)

    a = pt.render(world, cam, s, samples=2, key=key(5))
    b = pt.render(world, cam, s, samples=2, key=key(5))
    c = pt.render(world, cam, s, samples=2, key=key(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
    ref = pt.render(world, cam, s, samples=12, key=key(7))
    lo = accumulate([pt.render(world, cam, s, samples=1, key=key(8 + i))
                     for i in range(2)])
    hi = pt.render(world, cam, s, samples=6, key=key(8))
    assert (hi - ref).abs().mean() < (lo - ref).abs().mean()
    assert trt.to_srgb8(hi).shape == (16, 32, 3)
