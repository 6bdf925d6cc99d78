"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the fused frame (with and without the shadow leg), the state-plane
march and its start marks (camera rays and per-ray bundles) and the split
shade, each equal word for word, and each wrapper refusing a wrong dtype
or shape.

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
SUN = (1000.0, 2500.0, 500.0)


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


def _rays(rg, prep, mats, cam, bundle=False):
    """A frame's inputs and the rays of its state-plane march: none for
    the camera rays, with ``bundle`` the frame's shadow rays."""
    args, kw = t4.frame_args(rg, cam, mats.color, prepared=prep,
                             step_cap=500, sun_pos=SUN)
    scal, gw2, lut, swc, wmp = args
    dims = dict(height=kw["height"], width=kw["width"])
    rays = ()
    if bundle:
        ts, fl, _, _ = t4.march_planes4_ref(scal, gw2, swc, wmp, **dims)
        rays = t4._shadow_prep4(ts, fl, scal.cpu().numpy())
    return args, kw, dims, rays


def _planes(rg, prep, mats, cam, bundle=False):
    """Kernel and plain state planes of a frame's camera rays, or with
    ``bundle`` of its shadow rays; plus the frame's inputs. One call of
    the wrapper launches the mark kernel and the march kernel once each."""
    args, kw, dims, rays = _rays(rg, prep, mats, cam, bundle)
    scal, gw2, lut, swc, wmp = args
    before = t4.march_planes4.launches, t4.touched4.launches
    got = t4.march_planes4(scal, gw2, swc, wmp, *rays, **dims)
    torch.cuda.synchronize()
    assert (t4.march_planes4.launches, t4.touched4.launches) == \
        (before[0] + 1, before[1] + 1)
    return got, t4.march_planes4_ref(scal, gw2, swc, wmp, *rays, **dims), \
        (args, kw)


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


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


@pytest.mark.parametrize("i", range(len(CAMS)))
@pytest.mark.parametrize("size", [(200, 120), (72, 36)])
def test_fused_shadow_kernel_equals_plain_version(card_world, i, size):
    rg, prep, mats = card_world
    cam = CamData.create(CAMS[i][0], CAMS[i][1], 70.0, size)
    (img, fl), (rimg, rfl) = _both(rg, prep, mats, cam, step_cap=500,
                                   sun_pos=SUN, shadows=True)
    assert torch.equal(fl, rfl) and torch.equal(img, rimg)


@pytest.mark.parametrize("i", range(len(CAMS)))
@pytest.mark.parametrize("bundle", [False, True])
def test_planes_kernel_equals_plain_version(card_world, i, bundle):
    """Camera rays, and per-ray bundles (the frame's shadow rays), at
    200x120: four superblocks, some of them without an active ray."""
    rg, prep, mats = card_world
    cam = CamData.create(CAMS[i][0], CAMS[i][1], 70.0, (200, 120))
    got, ref, _ = _planes(rg, prep, mats, cam, bundle)
    assert all(_same_bits(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("i", range(len(CAMS)))
@pytest.mark.parametrize("bundle", [False, True])
def test_touched_kernel_equals_plain_version(card_world, i, bundle):
    """Start marks of camera rays and of the frame's shadow rays at
    200x120, a frame whose last tile column is partial."""
    rg, prep, mats = card_world
    cam = CamData.create(CAMS[i][0], CAMS[i][1], 70.0, (200, 120))
    args, _, dims, rays = _rays(rg, prep, mats, cam, bundle)
    before = t4.touched4.launches
    marks = t4.touched4(args[0], *rays, **dims)
    torch.cuda.synchronize()
    assert t4.touched4.launches == before + 1
    assert marks.shape == (15, 13) and marks.dtype == torch.uint8
    assert torch.equal(marks, t4.touched4_ref(args[0], *rays, **dims))


@pytest.mark.parametrize("i", range(len(CAMS)))
@pytest.mark.parametrize("shadows", [False, True])
def test_shade_kernel_equals_plain_version(card_world, i, shadows):
    rg, prep, mats = card_world
    cam = CamData.create(CAMS[i][0], CAMS[i][1], 70.0, (200, 120))
    (ts, fl, wa, we), _, (args, kw) = _planes(rg, prep, mats, cam)
    row = torch.from_numpy(t4._split_shade_row(args[0].cpu().numpy())).cuda()
    sh = (fl >> 3) & 1  # any 0/1 plane serves as a shadow plane here
    skw = dict(show_steps=i == 0, shadows=shadows, max_steps=kw["max_steps"])
    before = t4.shade4.launches
    img = t4.shade4(row, args[2], ts, fl, wa, we, sh, **skw)
    torch.cuda.synchronize()
    assert t4.shade4.launches == before + 1
    assert torch.equal(img, t4.shade4_ref(row, args[2], ts, fl, wa, we, sh,
                                          **skw))


def test_split_frame_equals_fused_on_the_card(card_world):
    rg, prep, mats = card_world
    for i in range(4):
        cam = CamData.create(CAMS[i][0], CAMS[i][1], 70.0, (200, 120))
        kw = dict(prepared=prep, with_flags=True, step_cap=500, sun_pos=SUN,
                  shadows=True)
        a = t4.render_frame4(rg, cam, mats.color, fused=True, **kw)
        b = t4.render_frame4(rg, cam, mats.color, fused=False, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_new_kernels_reject_bad_inputs(card_world):
    rg, prep, mats = card_world
    cam = CamData.create(CAMS[0][0], CAMS[0][1], 70.0, (64, 32))
    (ts, fl, wa, we), _, (args, _) = _planes(rg, prep, mats, cam)
    scal, gw2, lut, swc, wmp = args
    o = torch.zeros(32, 64, 3, device="cuda")
    act = torch.zeros(32, 64, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="active"):
        t4.march_planes4(scal, gw2, swc, wmp, o, o, act.int(), height=32,
                         width=64)
    with pytest.raises(ValueError, match="origins"):
        t4.march_planes4(scal, gw2, swc, wmp, o[:16], o, act, height=32,
                         width=64)
    with pytest.raises(ValueError, match="dirs"):
        t4.touched4(scal, o, o.double(), act, height=32, width=64)
    with pytest.raises(ValueError, match="fl"):
        t4.shade4(scal, lut, ts, fl.float(), wa, we, None)
    with pytest.raises(ValueError, match="sh"):
        t4.shade4(scal, lut, ts, fl, wa, we, fl[:, :8], shadows=True)


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
