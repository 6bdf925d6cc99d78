"""Near-axis camera rays: the port rounds as JAX's op sequence does.

Two cameras on the 4-chunk demo world at 72x36 give other flag words in
the port's fused frame than in JAX's ``render_frame4`` on the CPU: a
camera at (64, 70, 64), rotation (40, 135, 0), on 12 pixels (most of them
on column 36, whose rays point exactly along the x/z diagonal), and one at
(30, 72, 100), rotation (35, 300, 0), on one pixel. The cause is XLA's,
not the port's. JAX's Pallas kernel runs in interpret mode on the CPU,
and XLA compiles it as one program, contracting ``a*b+c`` into FMAs: its
camera rays differ from the uncontracted ones by an ulp on about 60% of
the pixels, and its march's slab distances too, which tips the face
(axis and sign bits) that a ray near a voxel edge enters through. JAX's
own program evaluated one primitive at a time (``jax_op_by_op``, every
multiply and add rounded on its own) gives the port's words. The one
pixel left, (34, 14) of the first camera, is a ray that JAX's 64-round
budget leaves active (flag bit 0): the port's march has no rounds.

So these tests pin the port to JAX's uncontracted math at those pixels:
the camera rows and every pixel's ray direction, bit for bit, and the
march of the 13 rays as a bundle, every field bit for bit. JAX's jitted
trace of that bundle (at the same budget) parts from both on the faces
of 9 rays and the ``t`` of 3 (measured; not run here, for time: it
compiles for 9 s). The op-by-op program is evaluated in NumPy, and held
word for word to the same walk with every primitive bound in JAX alone,
as ``jax.disable_jit()`` dispatches them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelraytracing_tpu.ops import noise as j_noise
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.ops.wavefront3 import _cam_scal as j_cam_scal
from voxelraytracing_tpu.ops.wavefront3 import build_render_grid3_host
from voxelraytracing_tpu.ops.wavefront4 import trace_wavefront4_rays as j_trace
from voxelraytracing_tpu.world.demo import demo_chunk_grids_host, demo_materials
from voxelraytracing_tpu_torch.convert import render_grid3_from_numpy
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.ops.camera import CamData
from voxelraytracing_tpu_torch.ops.wavefront3 import (
    RenderGrid3, _cam_scal, _pixel_dirs)
from jax_op_by_op import numpy_op_by_op
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

SIZE = (72, 36)
# (rotation, position, the pixels (x, y) whose flags differ from JAX's
# jitted frame) of the two cameras
CAMS = [
    ((40.0, 135.0, 0.0), (64.0, 70.0, 64.0),
     [(36, 1), (36, 2), (36, 4), (36, 6), (36, 8), (36, 9), (36, 10),
      (36, 13), (34, 14), (36, 19), (29, 25), (36, 26)]),
    ((35.0, 300.0, 0.0), (30.0, 72.0, 100.0), [(37, 12)]),
]
# a budget at which JAX's service converges on these rays (all of them
# finish); the port's march has no rounds
BUDGET = dict(rounds=8, steps_per_round=256, step_cap=500)
FIELDS = ("hit", "voxel", "norm", "t", "water_dist", "steps")


def _scal(cam):
    return _cam_scal(cam.pos, cam.inv_view, cam.inv_proj, 128, *SIZE, 0.0)


def _jax_dirs(s, px, py):
    """JAX's in-kernel camera ray (wavefront3._ray_dirs :469-480)."""
    x = px * s[4] - 1.0
    y = py * s[5] - 1.0
    ex = x * s[6] - y * s[7] + s[8]
    ey = x * s[9] - y * s[10] + s[11]
    dx = ex * s[12] + ey * s[15] - s[18]
    dy = ex * s[13] + ey * s[16] - s[19]
    dz = ex * s[14] + ey * s[17] - s[20]
    n = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    return jnp.stack([dx / n, dy / n, dz / n], -1)


def _words(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("cam", range(len(CAMS)))
def test_camera_rays_equal_jax_uncontracted(cam):
    """The camera row equals JAX's word for word, and every pixel's
    direction equals JAX's ray math evaluated op by op; jitted, JAX's
    differs on 1,579 and 1,635 of the 2,592 pixels (measured), the
    differing pixels' among them."""
    rot, pos, _ = CAMS[cam]
    jc = JCamData.create(rot, pos, 70.0, SIZE)
    tc = CamData.create(rot, pos, 70.0, SIZE)
    s = _scal(tc)
    js = j_cam_scal(jnp.asarray(jc.pos, jnp.float32),
                    jnp.asarray(jc.inv_view, jnp.float32),
                    jnp.asarray(jc.inv_proj, jnp.float32), 128, *SIZE, 0.0)
    np.testing.assert_array_equal(_words(js), _words(s))
    py, px = np.meshgrid(np.arange(SIZE[1], dtype=np.float32),
                         np.arange(SIZE[0], dtype=np.float32), indexing="ij")
    sf = [float(v) for v in s]
    got = np.stack([d.numpy() for d in _pixel_dirs(
        sf, torch.from_numpy(px), torch.from_numpy(py))], -1)
    with jax.disable_jit():
        eager = _jax_dirs(sf, jnp.asarray(px), jnp.asarray(py))
    jitted = jax.jit(_jax_dirs, static_argnums=0)(tuple(sf), px, py)
    np.testing.assert_array_equal(_words(got), _words(eager))
    apart = (_words(got) != _words(jitted)).any(-1).sum()
    assert 1000 < apart < SIZE[0] * SIZE[1], apart


@pytest.fixture(scope="module")
def bundle():
    """The 4-chunk demo world in both packages and the 13 rays of the
    differing pixels as a 16x8 bundle (the rest repeat the first ray,
    inactive)."""
    w = 4
    grids, cells = demo_chunk_grids_host(
        j_noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    jrg = build_render_grid3_host(grids, cells, np.zeros(3, np.int32), w,
                                  demo_materials())
    trg = render_grid3_from_numpy(
        *[np.asarray(getattr(jrg, f)) for f in RenderGrid3._fields],
        device="cpu")
    o = np.zeros((8, 16, 3), np.float32)
    d = np.zeros((8, 16, 3), np.float32)
    act = np.zeros((8, 16), bool)
    rays = []
    for rot, pos, pix in CAMS:
        sf = [float(v) for v in _scal(CamData.create(rot, pos, 70.0, SIZE))]
        px, py = (torch.tensor([p[i] for p in pix], dtype=torch.float32)
                  for i in (0, 1))
        dirs = torch.stack(_pixel_dirs(sf, px, py), -1).numpy()
        rays += [(pos, di) for di in dirs]
    for i, (pos, di) in enumerate(rays):
        o[i // 16, i % 16], d[i // 16, i % 16], act[i // 16, i % 16] = pos, di, True
    o[~act], d[~act] = rays[0][0], rays[0][1]
    return jrg, trg, o, d, act


def test_bundle_march_equals_jax_uncontracted(bundle):
    """The 13 rays marched as a bundle: the port's trace equals JAX's
    ``trace_wavefront4_rays`` evaluated op by op in every field, bit for
    bit (9 of the rays leave the world: their exit face is the flag
    bits in question)."""
    jrg, trg, o, d, act = bundle
    kw = dict(width=16, height=8, **BUDGET)
    got = t4.trace_wavefront4_rays(trg, o, d, act, **kw)

    def jax_trace():
        return j_trace(jrg, o, d, act, **kw)

    eager = numpy_op_by_op(jax_trace)()
    # direction components near zero, where zero signs decide: the NumPy
    # rules held to every primitive bound in JAX alone (as
    # jax.disable_jit() dispatches them), word for word
    dispatched = numpy_op_by_op(jax_trace, jax_only=True)()
    for f, e, x in zip(FIELDS, eager, dispatched):
        g = np.asarray(getattr(got, f))
        e, x = (np.asarray(y).reshape(g.shape) for y in (e, x))
        if g.dtype == np.float32:
            g, e, x = _words(g), _words(e), _words(x)
        np.testing.assert_array_equal(e, x, f)
        np.testing.assert_array_equal(g[act], e[act], f)
    assert int(np.asarray(got.hit)[act].sum()) == 4
