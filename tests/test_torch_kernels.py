"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed (with ``--noconftest``: tests/conftest.py sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from voxelraytracing_tpu_torch.ops import noise
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.ops.camera import CamData
from voxelraytracing_tpu_torch.ops.wavefront3 import build_render_grid3_host
from voxelraytracing_tpu_torch.world.demo import (
    demo_chunk_grids_host,
    demo_materials,
)

pytestmark = pytest.mark.cuda

CAMS = [
    ((30.0, 45.0, 0.0), (64.0, 75.0, 64.0)),
    ((5.0, 120.0, 0.0), (20.0, 40.0, 100.0)),
    ((60.0, 200.0, 0.0), (100.0, 110.0, 30.0)),
    ((-20.0, 300.0, 0.0), (64.0, 20.0, 64.0)),
    ((30.0, 45.0, 0.0), (-50.0, 75.0, 64.0)),  # outside the world
]


@pytest.fixture(scope="module")
def card_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = 4
    grids, cells = demo_chunk_grids_host(
        noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    mats = demo_materials()
    rg = build_render_grid3_host(grids, cells, np.zeros(3, np.int32), w, mats,
                                 device="cuda")
    return rg, t4.prepare_grid4(rg), mats


def _both(rg, prep, mats, cam, **kw):
    args, fkw = t4.frame_args(rg, cam, mats.color, prepared=prep, **kw)
    before = t4.march_fused4.launches
    got = t4.march_fused4(*args, **fkw)
    torch.cuda.synchronize()
    assert t4.march_fused4.launches == before + 1
    return got, t4.march_fused4_ref(*args, **fkw)


@pytest.mark.parametrize("i", range(len(CAMS)))
@pytest.mark.parametrize("size", [(200, 120), (72, 36)])
def test_kernel_equals_plain_version(card_world, i, size):
    rg, prep, mats = card_world
    cam = CamData.create(CAMS[i][0], CAMS[i][1], 70.0, size)
    (img, fl), (rimg, rfl) = _both(rg, prep, mats, cam, step_cap=500,
                                   sun_pos=(1000.0, 2500.0, 500.0))
    assert img.shape == (size[1], size[0]) and img.device.type == "cuda"
    assert torch.equal(fl, rfl)
    assert torch.equal(img, rimg)


@pytest.mark.parametrize("cap", [None, 20])
def test_kernel_step_cap_and_heatmap(card_world, cap):
    rg, prep, mats = card_world
    cam = CamData.create(CAMS[0][0], CAMS[0][1], 70.0, (128, 64))
    (img, fl), (rimg, rfl) = _both(rg, prep, mats, cam, step_cap=cap,
                                   show_steps=True, rounds=4,
                                   steps_per_round=64)
    assert torch.equal(fl, rfl) and torch.equal(img, rimg)
    if cap:
        assert int(((fl >> 5) & 0xFFF).max()) == cap


def test_kernel_rejects_bad_tables(card_world):
    rg, prep, mats = card_world
    cam = CamData.create(CAMS[0][0], CAMS[0][1], 70.0, (64, 32))
    args, kw = t4.frame_args(rg, cam, mats.color, prepared=prep)
    bad = list(args)
    bad[3] = args[3].to(torch.int64)
    with pytest.raises(ValueError, match="sw_cont"):
        t4.march_fused4(*bad, **kw)
    bad[3] = args[3]
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError, match="gw2"):
        t4.march_fused4(*bad, **kw)
