"""The scene, cameras and tolerances shared by the v3 tests of the port
(tests/test_torch_v3_*.py).

The world is the 4-chunk demo world of tests/test_wavefront3.py:25-37
(noise seed 7), built by the JAX host builder and carried over with
``convert.render_grid3_from_numpy``; the cameras are that file's CAMS.

Tolerances, each with its reason: hits, ids, steps, flags, wants, tokens
and packed RGBA8 agree exactly. ``t`` and the water length agree within
``T_RTOL`` relative and ``W_ATOL`` absolute: XLA's CPU compiler contracts
``a*b+c`` into FMAs inside the interpret-mode kernel (ROADMAP queue 3), so
a position ``o + d*t`` can differ by an ulp, and the next DDA distance
``(plane - p) / d`` multiplies that by up to 1e7 on near-axis rays. Rays
that stop mid-flight (a step cap of 4) keep such a ``t``: measured here at
64x32, at most 2.0e-6 relative (2.7e-5 absolute, t near 13); rays that
hit or leave the world stay within 1e-6.
"""

import numpy as np

from voxelraytracing_tpu.ops import noise as j_noise
from voxelraytracing_tpu.ops import wavefront3 as j3
from voxelraytracing_tpu.world.demo import demo_chunk_grids_host, demo_materials
from voxelraytracing_tpu_torch.convert import render_grid3_from_numpy
from voxelraytracing_tpu_torch.ops.wavefront3 import RenderGrid3

CAMS = [
    ((30.0, 45.0, 0.0), (64.0, 75.0, 64.0)),
    ((5.0, 120.0, 0.0), (20.0, 40.0, 100.0)),
    ((60.0, 200.0, 0.0), (100.0, 110.0, 30.0)),
    ((-20.0, 300.0, 0.0), (64.0, 20.0, 64.0)),  # underwater, looking up
]
SIZE = (64, 32)
SUN = (1000.0, 2500.0, 500.0)
T_RTOL = 4e-6
W_ATOL = 5e-5


def scene(w=4, mats=None):
    """``(jax_grid, port_grid_on_cpu, materials)`` of the demo world."""
    mats = demo_materials() if mats is None else mats
    grids, cells = demo_chunk_grids_host(
        j_noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    jrg = j3.build_render_grid3_host(grids, cells, np.zeros(3, np.int32), w,
                                     mats)
    trg = render_grid3_from_numpy(
        *[np.asarray(getattr(jrg, f)) for f in RenderGrid3._fields],
        device="cpu")
    return jrg, trg, mats


def assert_result(got, want):
    """A port ``WavefrontResult`` against a JAX one, under the bars above."""
    for f in ("hit", "voxel", "steps", "norm"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                               rtol=T_RTOL, atol=0)
    np.testing.assert_allclose(got.water_dist.numpy(),
                               np.asarray(want.water_dist), rtol=0,
                               atol=W_ATOL)


def assert_token(got, want):
    """A port frame-cache token against JAX's, word for word."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

