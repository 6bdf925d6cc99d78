"""A grid with overflowed subwindow palettes renders in the port as in the
JAX package.

The noise grid of tests/test_torch_world.py holds 23 voxel ids in 2
chunks, so subwindows hold more than 16 distinct solid ids and
``palettes_ok`` is False. JAX's v4 frame never reads that flag: hit ids
decode from the overflowed palette, whose most frequent entry stands in
for the ids left out. The port builds the same palette bits, so the same
frame comes out. The JAX frame runs its Pallas kernel in interpret mode on
the CPU; the port runs its plain PyTorch version on CPU tensors.

Tolerances: flags and every hit pixel's packed word exactly equal; a sky
channel within 1/255, because the two libms may round ``** 0.35``
differently.
"""

import logging

import numpy as np

from voxelraytracing_tpu.ops import materials as j_materials
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.ops.wavefront3 import build_render_grid3_host
from voxelraytracing_tpu.ops.wavefront4 import render_frame4 as j_render_frame4
from voxelraytracing_tpu_torch.convert import render_grid3_from_numpy
from voxelraytracing_tpu_torch.ops import wavefront3 as t3
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.ops.camera import CamData
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

CAM = ((40.0, 30.0, 0.0), (12.0, 62.0, 12.0))
SIZE = (64, 32)
KW = dict(sun_pos=(1000.0, 2500.0, 500.0), step_cap=500, rounds=64,
          with_flags=True, fused=True)


def _noise_world():
    """tests/test_torch_world.py's noise grid, built by the JAX package."""
    rng = np.random.default_rng(20261016)
    w = 2
    styles = {
        i: {"color": tuple(float(c) for c in rng.random(3)),
            "state": "liquid" if i in (3, 7, 11) else "solid"}
        for i in range(1, 24)
    }
    grids = rng.integers(0, 24, size=(w ** 3, 32, 32, 32)).astype(np.int32)
    grids[:, :, 24:, :] = 0
    grids[:, :, 16:24, :] = 7
    grids[:, 5:9, 10:14, 3:30] = 3
    cells = np.arange(w ** 3, dtype=np.int32)
    cells[5] = -1
    mats = j_materials.make_material_table(40, styles)
    jrg = build_render_grid3_host(grids, cells, np.zeros(3, np.int32), w, mats)
    return jrg, mats


def test_palette_overflow_frame_matches_jax(caplog):
    """The frame of a ``palettes_ok=False`` grid equals JAX's, and the
    port's renderer logs a warning, as JAX's render_frame3 does."""
    jrg, mats = _noise_world()
    jimg, jfl = j_render_frame4(
        jrg, JCamData.create(CAM[0], CAM[1], 70.0, SIZE), mats.color, **KW)
    jimg, jfl = np.asarray(jimg), np.asarray(jfl)
    trg = render_grid3_from_numpy(
        *[np.asarray(getattr(jrg, f)) for f in t3.RenderGrid3._fields],
        device="cpu")
    assert not trg.palettes_ok
    with caplog.at_level(logging.WARNING):
        img, fl = t4.render_frame4(
            trg, CamData.create(CAM[0], CAM[1], 70.0, SIZE), mats.color, **KW)
    assert "overflowed subwindow palettes" in caplog.text
    img, fl = img.numpy().view(np.uint32), fl.numpy()

    np.testing.assert_array_equal(fl, jfl)
    hit = ((jfl >> 1) & 1) != 0
    assert not (img != jimg)[hit].any(), "a hit pixel's color differs"
    for sh in (0, 8, 16):
        ch = np.abs(((img >> sh) & 255).astype(int)
                    - ((jimg >> sh) & 255).astype(int))
        assert ch.max() <= 1, "a sky channel differs by more than 1/255"
    assert len(np.unique(((fl >> 17) & 0xFF)[hit])) > 4
