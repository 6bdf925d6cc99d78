"""The port's one-launch path tracer (``path_trace_fused4``, plain version
``pt4_ref``) against the JAX package's on the CPU, and against the port's
own ``path_trace3``.

The 2-chunk worlds and camera of tests/test_pathtrace4.py:37-69 feed both
packages (see tests/test_torch_pathtrace.py). JAX runs its Pallas kernel
in interpret mode at ``rounds=96``, where its legs converge at 64x32
(test_pathtrace4.py:120-132 shows 48 and 96 agree); each JAX golden is
computed once, in a module fixture.

Tolerances, each with its reason:
  * mirror materials (no draw): ``rtol=1e-5, atol=1e-6``, as in
    tests/test_torch_pathtrace.py (ulps of ``exp``/``** 0.35`` between the
    libms and of XLA's FMA contraction in ``t``; measured here at most
    2.7e-7 absolute, 5.4e-6 relative);
  * diffuse frames: the path-tracing bar, at least 99% of pixels with
    every channel within 2/255 (measured: every pixel, at most 4.5e-7
    apart);
  * the port's two routes where nothing is drawn (``bounces=0``, mirror
    materials): bit for bit, as JAX pins its own two routes
    (test_pathtrace4.py:72-90). They share the march and the leg-end
    functions.
"""

import jax
import numpy as np
import pytest
import torch

from voxelraytracing_tpu.ops import noise as j_noise
from voxelraytracing_tpu.ops import wavefront3 as j3
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.ops.materials import make_material_table
from voxelraytracing_tpu.ops.pathtrace4 import (
    path_trace_fused4 as j_path_trace_fused4,
)
from voxelraytracing_tpu.world.demo import demo_chunk_grids_host, demo_materials
from voxelraytracing_tpu_torch.convert import render_grid3_from_numpy
from voxelraytracing_tpu_torch.ops import pathtrace3 as p3
from voxelraytracing_tpu_torch.ops import pathtrace4 as p4
from voxelraytracing_tpu_torch.ops import prng
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
# (scene, bounces, samples, key): the JAX goldens
# (scene, bounces, samples, key): both frames have two bounces and two
# samples, so one JAX program serves both (two samples of the mirror
# frame draw nothing and equal one)
GOLDEN = (("mirror", 2, 2, 0), ("diffuse", 2, 2, 3))
RNG_FREE = (("diffuse", 0), ("mirror", 1), ("mirror", 2))


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
    """Both worlds and the JAX path_trace_fused4 frames of GOLDEN (two
    JAX path-trace calls, one compile)."""
    sc = {"diffuse": _scene(demo_materials()),
          "mirror": _scene(make_material_table(256, MIRROR))}
    cam = JCamData.create(*CAM)
    gold = {}
    for name, bounces, samples, key in GOLDEN:
        jrg, _, mats = sc[name]
        gold[name] = np.asarray(j_path_trace_fused4(
            jrg, cam, mats, sun_pos=SUN, bounces=bounces, samples=samples,
            key=jax.random.PRNGKey(key), rounds=96, step_cap=500))
    return sc, gold


def _fused(trg, mats, bounces, samples=1, key=0, size=CAM[3], **kw):
    img = p4.path_trace_fused4(
        trg, CamData.create(*CAM[:3], size), mats, sun_pos=SUN,
        bounces=bounces, samples=samples,
        key=np.asarray(jax.random.PRNGKey(key)), step_cap=500, **kw)
    assert img.dtype == torch.float32 and img.device.type == "cpu"
    return img.numpy()


def test_fused_mirror_matches_jax(scenes):
    sc, gold = scenes
    name, bounces, samples, key = GOLDEN[0]
    _, trg, mats = sc[name]
    got = _fused(trg, mats, bounces, samples, key)
    np.testing.assert_allclose(got, gold[name], rtol=1e-5, atol=1e-6)
    assert (got > 0).any()


def test_fused_diffuse_meets_the_pt_bar(scenes):
    """Two samples of two bounces: the seed quads, the per-sample base and
    the bounces-left counter draw what the JAX kernel draws."""
    sc, gold = scenes
    name, bounces, samples, key = GOLDEN[1]
    _, trg, mats = sc[name]
    got = _fused(trg, mats, bounces, samples, key)
    d = np.abs(got.astype(np.float64) - gold[name]).max(axis=-1)
    assert float((d <= 2.0 / 255.0).mean()) >= 0.99
    want = float(gold[name].mean())
    assert abs(float(got.mean()) - want) < 1e-3 * want
    other = _fused(trg, mats, bounces, samples, key + 1)
    assert float((np.abs(other - gold[name]).max(-1) <= 2 / 255).mean()) < 0.99


@pytest.mark.parametrize("case", RNG_FREE, ids=lambda c: f"{c[0]}-b{c[1]}")
def test_fused_equals_path_trace3_without_draws(scenes, case):
    sc, _ = scenes
    name, bounces = case
    _, trg, mats = sc[name]
    fused = _fused(trg, mats, bounces)
    v4 = p3.path_trace3(trg, CamData.create(*CAM), mats, sun_pos=SUN,
                        bounces=bounces, key=None, step_cap=500, v4=True)
    np.testing.assert_array_equal(fused, v4.numpy())


def test_fused_schedule_knobs_are_ignored(scenes):
    sc, _ = scenes
    _, trg, mats = sc["diffuse"]
    a = _fused(trg, mats, 1)
    b = _fused(trg, mats, 1, rounds=2, steps_per_round=8, s_seg=4, blk=128,
               n_sc=32, s_ins=8, w_ins=4, interpret=True)
    np.testing.assert_array_equal(a, b)


def test_ragged_frame_leaves_partial_tiles_black(scenes):
    """72x36: the last 8 columns and 4 rows are partial tiles, which the
    one-launch tracer never starts (pathtrace4.py:706-709): they stay
    black."""
    sc, _ = scenes
    _, trg, mats = sc["mirror"]
    got = _fused(trg, mats, 1, size=(72, 36))
    assert got.shape == (36, 72, 3)
    assert not got[:, 64:].any() and not got[32:].any()
    assert got[:32, :64].any()


def test_seed_quads_carry_the_key():
    """The scalar row carries the key's words as exact 16-bit quads, and
    the per-sample base rebuilds them (pathtrace4.py:994-1005, :726-730)."""
    kd = np.asarray(jax.random.PRNGKey(123456789))
    rg = _scene(demo_materials())[1]
    row = p3.pt_scal(rg, CamData.create(*CAM), world_min=None,
                     sky_color=(0.81, 0.93, 1.0), sun_pos=SUN,
                     sun_intensity=4.0, step_cap=500, key=kd)
    quads = [int(q) for q in row[34:38]]
    assert quads[0] + (quads[1] << 16) == kd[0]
    assert quads[2] + (quads[3] << 16) == kd[1]
    sf = [float(x) for x in row]
    k0, k1 = int(kd[0]), int(kd[1])
    assert p4._seed_base(sf, 2) == \
        k0 ^ (k1 * 0x9E3779B9 & 0xFFFFFFFF) ^ (2 * 0x7FEB352D)
    np.testing.assert_array_equal(prng.key_data(kd), kd)


def test_wrappers_refuse_other_devices():
    meta = dict(device="meta")
    fl = torch.empty(8, 16, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        p3.matfetch4(fl, torch.empty(10, 128, **meta))
    args = (torch.empty(43, **meta),
            torch.empty(2, 128, dtype=torch.int32, **meta),
            torch.empty(10, 128, **meta),
            torch.empty(64, 7, 128, dtype=torch.int32, **meta),
            torch.empty(1, 1, 128, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="cuda or cpu"):
        p4.pt4(*args, height=8, width=16, bounces=1, samples=1)
