"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the fused frame (with and without the shadow leg), the state-plane
march and its start marks (camera rays and per-ray bundles), their
sparse-table instantiations (on the 4-chunk demo world and a 34-chunk
scene), the split shade and the material fetch, each equal word for
word; the v3 march at every launch of whole frames (camera rays, shadow
bundles, compacted grids, lookahead); the v2 march at every round of
whole frames and on a round that tells a program-wide ``go`` from a
per-tile one; sparse frames equal to dense ones;
the one-launch path tracer, equal where nothing is drawn and within the
path-tracing bar elsewhere, and equal to the v4 path-tracing route where
nothing is drawn; each wrapper refusing a wrong dtype or shape.

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


@pytest.mark.parametrize("shadows", [False, True])
def test_kernel_nan_direction_takes_no_step(card_world, shadows):
    """Rays with no direction (the camera basis of ``scal`` zeroed, so
    each direction is 0/0) take no step, as in the plain version, whose
    bounds test is false on a NaN position, and pack the plain version's
    words: a NaN sky is byte 0 in every channel."""
    rg, prep, mats = card_world
    cam = CamData.create(CAMS[0][0], CAMS[0][1], 70.0, (64, 32))
    args, fkw = t4.frame_args(rg, cam, mats.color, prepared=prep,
                              step_cap=500, sun_pos=SUN, shadows=shadows)
    scal = args[0].clone()
    scal[12:21] = 0.0
    args = (scal,) + tuple(args[1:])
    img, fl = t4.march_fused4(*args, **fkw)
    rimg, rfl = t4.march_fused4_ref(*args, **fkw)
    assert int(rfl.abs().sum()) == 0 and torch.equal(fl, rfl)
    assert bool((rimg == -0x1000000).all()) and torch.equal(img, rimg)


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


# ------------------------------------------------------------ path tracing

MIRROR = {
    1: {"color": (0.55, 0.55, 0.55), "state": "solid", "scatter": 0.0,
        "emission": 0.5},
    2: {"color": (0.55, 0.35, 0.15), "state": "solid", "scatter": 0.0},
    3: {"color": (0.30, 0.68, 0.24), "state": "solid", "scatter": 0.0},
    4: {"color": (0.12, 0.30, 0.85), "state": "liquid", "scatter": 0.0},
}


@pytest.fixture(scope="module")
def pt_worlds(card_world):
    """The demo world and the same terrain with the mirror table of
    tests/test_pathtrace4.py:53-66 (scatter 0 everywhere: no draw)."""
    from voxelraytracing_tpu_torch.ops.materials import make_material_table

    rg, _, mats = card_world
    w = 4
    grids, cells = demo_chunk_grids_host(
        noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    mirror = make_material_table(256, MIRROR)
    mrg = build_render_grid3_host(grids, cells, np.zeros(3, np.int32), w,
                                  mirror, device="cuda")
    return {"demo": (rg, mats), "mirror": (mrg, mirror)}


def _pt_args(rg, mats, cam, key=(7, 11)):
    from voxelraytracing_tpu_torch.ops import pathtrace3 as p3

    return p3.pt_inputs(rg, cam, mats, sun_pos=SUN, step_cap=500,
                        key=np.asarray(key, np.uint32))


def _pt_bar(a, b):
    return float(((a - b).abs().amax(dim=-1) <= 2.0 / 255.0).float().mean())


@pytest.mark.parametrize("i", range(len(CAMS)))
def test_matfetch_kernel_equals_plain_version(pt_worlds, i):
    """The material fetch on a frame's flags and on words carrying every
    hit id; one launch a call."""
    from voxelraytracing_tpu_torch.ops import pathtrace3 as p3

    rg, mats = pt_worlds["demo"]
    cam = CamData.create(CAMS[i][0], CAMS[i][1], 70.0, (200, 120))
    (scal, gw2, mlut, swc, wmp), (h, w) = _pt_args(rg, mats, cam)
    fl = t4.march_planes4(scal, gw2, swc, wmp, height=h, width=w)[1]
    ids = torch.arange(fl.numel(), dtype=torch.int32, device="cuda") % 256
    words = (fl & ~(0xFF << 17)) | (ids.reshape(fl.shape) << 17)
    for x in (fl, words):
        before = p3.matfetch4.launches
        got = p3.matfetch4(x, mlut)
        torch.cuda.synchronize()
        assert p3.matfetch4.launches == before + 1
        assert all(torch.equal(a, b)
                   for a, b in zip(got, p3.matfetch4_ref(x, mlut)))


@pytest.mark.parametrize("bounces", [0, 1, 2])
@pytest.mark.parametrize("scene", ["demo", "mirror"])
def test_pt_kernel_equals_plain_version(pt_worlds, scene, bounces):
    """The one-launch path tracer against its plain version on four
    cameras and the outside one at 200x120: bit for bit where nothing is
    drawn (no bounce, mirror materials), else the path-tracing bar (99% of
    pixels within 2/255: the card's libm and torch's may round Box-Muller's
    log/sin/cos apart)."""
    from voxelraytracing_tpu_torch.ops import pathtrace4 as p4

    rg, mats = pt_worlds[scene]
    for i in range(len(CAMS)):
        cam = CamData.create(CAMS[i][0], CAMS[i][1], 70.0, (200, 120))
        args, (h, w) = _pt_args(rg, mats, cam)
        for samples in (1, 2) if bounces == 1 else (1,):
            kw = dict(height=h, width=w, bounces=bounces, samples=samples)
            before = p4.pt4.launches
            got = p4.pt4(*args, **kw)
            torch.cuda.synchronize()
            assert p4.pt4.launches == before + 1
            assert got.shape == (h, w, 3) and bool(torch.isfinite(got).all())
            ref = p4.pt4_ref(*args, **kw)
            if scene == "mirror" or bounces == 0:
                assert torch.equal(got, ref), (i, samples)
            else:
                assert _pt_bar(got, ref) >= 0.99, (i, samples)


@pytest.mark.parametrize("case", [("demo", 0), ("mirror", 1), ("mirror", 2)])
def test_path_tracer_routes_agree_on_the_card(pt_worlds, case):
    """Where nothing is drawn, the one-launch kernel equals the v4 route
    (march_planes4 legs, matfetch4, torch leg ends) bit for bit, on a
    frame of whole 16x8 tiles (the routes part on partial tiles, as in
    JAX: the v4 route shades them as sky, the one-launch kernel leaves
    them black); the v4 route launches the march and the fetch once for
    the camera leg and once for each bounce leg."""
    from voxelraytracing_tpu_torch.ops import pathtrace3 as p3
    from voxelraytracing_tpu_torch.ops import pathtrace4 as p4

    name, bounces = case
    rg, mats = pt_worlds[name]
    prep = t4.prepare_grid4(rg)
    for i in range(4):
        cam = CamData.create(CAMS[i][0], CAMS[i][1], 70.0, (192, 120))
        kw = dict(sun_pos=SUN, step_cap=500, bounces=bounces, prepared=prep)
        before = (p3.matfetch4.launches, t4.march_planes4.launches)
        a = p3.path_trace3(rg, cam, mats, v4=True, **kw)
        torch.cuda.synchronize()
        assert (p3.matfetch4.launches - before[0],
                t4.march_planes4.launches - before[1]) == (1 + bounces,) * 2
        b = p4.path_trace_fused4(rg, cam, mats, **kw)
        assert a.device.type == b.device.type == "cuda"
        assert torch.equal(a, b), i


def test_pt_kernels_reject_bad_inputs(pt_worlds):
    from voxelraytracing_tpu_torch.ops import pathtrace3 as p3
    from voxelraytracing_tpu_torch.ops import pathtrace4 as p4

    rg, mats = pt_worlds["demo"]
    cam = CamData.create(CAMS[0][0], CAMS[0][1], 70.0, (64, 32))
    (scal, gw2, mlut, swc, wmp), (h, w) = _pt_args(rg, mats, cam)
    fl = t4.march_planes4(scal, gw2, swc, wmp, height=h, width=w)[1]
    with pytest.raises(ValueError, match="fl"):
        p3.matfetch4(fl.float(), mlut)
    with pytest.raises(ValueError, match="mlut"):
        p3.matfetch4(fl, mlut[:6])
    kw = dict(height=h, width=w, bounces=1, samples=1)
    with pytest.raises(ValueError, match="mlut"):
        p4.pt4(scal, gw2, mlut.double(), swc, wmp, **kw)
    with pytest.raises(ValueError, match="scal"):
        p4.pt4(scal.cpu(), gw2, mlut, swc, wmp, **kw)
    with pytest.raises(ValueError, match="samples"):
        p4.pt4(scal, gw2, mlut, swc, wmp, **{**kw, "samples": 0})


# ----------------------------------------------------------- sparse tables

# tests/test_supercell.py:139-177: a 34-chunk window (gs=1), terrain
# islands at opposite corners and a floating water cube; most of its
# windows never get a chunk, so their subwindows have no content row
W34_CELLS = [(0, 0, 0), (1, 0, 0), (0, 0, 1), (1, 0, 1), (32, 0, 32),
             (33, 0, 33), (16, 8, 16)]
W34_CAMS = [
    ((35.0, 45.0, 0.0), (20.0, 60.0, 20.0)),
    ((14.5, 225.0, 0.0), (10.0, 400.0, 10.0)),
    ((70.0, 10.0, 0.0), (528.0, 400.0, 500.0)),
    ((4.2, 45.0, 0.0), (1080.0, 120.0, 1080.0)),
]


@pytest.fixture(scope="module")
def sparse_worlds(card_world):
    """Streaming builders on the card with sparse tables: the W=4 demo
    world (and its dense twin) and the W=34 scene."""
    from voxelraytracing_tpu_torch.world import demo
    from voxelraytracing_tpu_torch.world.render_grid import RenderGrid3Builder

    mats = demo_materials()
    grids, cells = demo_chunk_grids_host(
        noise.make_permutation(7), np.zeros(3, np.int64), 4, 4 * 32 * 0.45,
        int(4 * 32 * 0.28))
    cell_xyz = [(int(c % 4), int((c // 4) % 4), int(c // 16)) for c in cells]
    out = {}
    for sparse in (True, False):
        b = RenderGrid3Builder(4, mats, sparse=sparse, device="cuda")
        b.set_chunks(cell_xyz, grids)
        out["w4", sparse] = b
    terrain = np.zeros((32, 32, 32), np.int32)
    terrain[:, :12, :] = demo.STONE
    terrain[:, 12:14, :] = demo.EARTH
    terrain[:, 14, :] = demo.GRASS
    water = np.full((32, 32, 32), demo.WATER, np.int32)
    b = RenderGrid3Builder(34, mats, sparse=True, device="cuda")
    b.set_chunks(W34_CELLS, np.stack([terrain] * 6 + [water]))
    out["w34", True] = b
    return out, mats


def _sparse_cams(world, size):
    cams = CAMS if world == "w4" else W34_CAMS
    return [CamData.create(r, e, 70.0, size) for r, e in cams]


@pytest.mark.parametrize("world", ["w4", "w34"])
@pytest.mark.parametrize("shadows", [False, True])
def test_sparse_fused_kernel_equals_plain_version(sparse_worlds, world,
                                                  shadows):
    """The sparse instantiation of the fused kernel (with and without the
    shadow leg), one launch a call, word for word its plain version."""
    builders, mats = sparse_worlds
    b = builders[world, True]
    for cam in _sparse_cams(world, (200, 120)):
        args, kw = t4.frame_args(b.grid(), cam, mats.color,
                                 prepared=b.prepared(), step_cap=2000,
                                 sun_pos=SUN, shadows=shadows)
        assert kw["sparse_ns"] == b.ns
        before = t4.march_fused4.launches
        img, fl = t4.march_fused4(*args, **kw)
        torch.cuda.synchronize()
        assert t4.march_fused4.launches == before + 1
        rimg, rfl = t4.march_fused4_ref(*args, **kw)
        assert torch.equal(fl, rfl) and torch.equal(img, rimg)


@pytest.mark.parametrize("world", ["w4", "w34"])
@pytest.mark.parametrize("bundle", [False, True])
def test_sparse_planes_kernel_equals_plain_version(sparse_worlds, world,
                                                   bundle):
    """The sparse instantiation of the state-plane march on camera rays
    and on the frame's shadow bundle, word for word its plain version."""
    builders, mats = sparse_worlds
    b = builders[world, True]
    for cam in _sparse_cams(world, (200, 120)):
        args, kw = t4.frame_args(b.grid(), cam, mats.color,
                                 prepared=b.prepared(), step_cap=2000,
                                 sun_pos=SUN)
        scal, gw2, _, swc, wmp = args
        dims = dict(height=kw["height"], width=kw["width"],
                    sparse_ns=kw["sparse_ns"])
        rays = ()
        if bundle:
            ts, fl, _, _ = t4.march_planes4_ref(scal, gw2, swc, wmp, **dims)
            rays = t4._shadow_prep4(ts, fl, scal.cpu().numpy())
        before = t4.march_planes4.launches
        got = t4.march_planes4(scal, gw2, swc, wmp, *rays, **dims)
        torch.cuda.synchronize()
        assert t4.march_planes4.launches == before + 1
        ref = t4.march_planes4_ref(scal, gw2, swc, wmp, *rays, **dims)
        assert all(_same_bits(x, y) for x, y in zip(got, ref))


def test_sparse_frames_equal_dense_on_the_card(sparse_worlds):
    """Fused, fused-shadowed and split-shadowed frames of the W=4 world
    from the sparse token equal the dense token's, flags too."""
    builders, mats = sparse_worlds
    sp, dn = builders["w4", True], builders["w4", False]
    for cam in _sparse_cams("w4", (200, 120)):
        for fused, shadows in ((True, False), (True, True), (False, True)):
            kw = dict(with_flags=True, step_cap=500, sun_pos=SUN,
                      fused=fused, shadows=shadows)
            a = t4.render_frame4(sp.grid(), cam, mats.color,
                                 prepared=sp.prepared(), **kw)
            c = t4.render_frame4(dn.grid(), cam, mats.color,
                                 prepared=dn.prepared(), **kw)
            assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])


# ---------------------------------------------------------- the v3 march


def _flat(out):
    """The tensors of a wrapper's output, nested tuples flattened."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for o in out for x in _flat(o)]


def _held(kernel, ref, args, kw):
    """One call of the wrapper ``kernel`` on the card held against its
    plain version ``ref`` on the same inputs, word for word. The wrapper
    counts one call, and ``march2`` ``1 + sub_rounds`` CUDA launches
    inside it. Returns the kernel's outputs."""
    before = kernel.launches, getattr(kernel, "cuda_launches", 0)
    out = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before[0] + 1
    if hasattr(kernel, "cuda_launches"):
        assert kernel.cuda_launches == before[1] + 1 + kw["sub_rounds"]
    for a, b in zip(_flat(out), _flat(ref(*args, **kw)), strict=True):
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    return out


class _Both:
    """Stands in for the wrapper ``name`` of ``mod`` in a round loop while
    active: each call is held against the plain version (:func:`_held`)
    and its ``(args, kw)`` kept in ``calls``. The wrapper counts through
    its module name, which the stand-in holds while active, so the
    counts are forwarded to the real wrapper's."""

    COUNTS = ("launches", "cuda_launches")

    def __init__(self, mod, name):
        self.mod, self.name, self.calls = mod, name, []
        self.kernel = getattr(mod, name)

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return _held(self.kernel, getattr(self.mod, self.name + "_ref"),
                     args, kw)

    def __getattr__(self, k):
        if k not in self.COUNTS:
            raise AttributeError(k)
        return getattr(self.kernel, k)

    def __setattr__(self, k, n):
        if k in self.COUNTS:
            setattr(self.kernel, k, n)
        else:
            super().__setattr__(k, n)

    def __enter__(self):
        setattr(self.mod, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.kernel)


def _v3_launches(fn):
    """Run ``fn`` with every ``march3`` launch held against ``march3_ref``;
    returns the modes of the launches (bundle, tile map, lookahead)."""
    from voxelraytracing_tpu_torch.ops import wavefront3 as t3

    with _Both(t3, "march3") as both:
        fn()
    return [(a[6] is not None, a[7] is not None, kw["lookahead"])
            for a, kw in both.calls]


@pytest.mark.parametrize("i", range(len(CAMS)))
@pytest.mark.parametrize("rounds", [2, 16])
def test_march3_kernel_equals_plain_version(card_world, i, rounds):
    """Every launch of a shadowed v3 frame (camera rays, then the shadow
    bundle), word for word, at a starved and a longer budget."""
    from voxelraytracing_tpu_torch.ops.wavefront3 import render_frame3

    rg, _, mats = card_world
    cam = CamData.create(*CAMS[i], 70.0, (200, 120))
    seen = _v3_launches(lambda: render_frame3(
        rg, cam, mats.color, sun_pos=SUN, shadows=True, rounds=rounds,
        step_cap=500))
    assert seen and not seen[0][0]


@pytest.mark.parametrize("lookahead", [1, 2])
def test_march3_kernel_compacted_and_lookahead(card_world, lookahead):
    """A 256x128 trace whose round loop compacts its tiles (tile map), with
    and without the lookahead want-list."""
    from voxelraytracing_tpu_torch.ops.wavefront3 import trace_wavefront3

    rg, _, _ = card_world
    cam = CamData.create(*CAMS[0], 70.0, (256, 128))
    seen = _v3_launches(lambda: trace_wavefront3(
        rg, np.asarray(cam.pos, np.float32), cam=cam, rounds=8, step_cap=500,
        compact=(2, 8), lookahead=lookahead))
    assert any(tm for _, tm, _ in seen)
    assert all(la == lookahead for _, _, la in seen)


def test_march3_rejects_bad_inputs(card_world):
    from voxelraytracing_tpu_torch.ops import wavefront3 as t3

    st = torch.zeros((64, 128), device="cuda")
    mc = torch.zeros((1, t3.MC_ROWS, 128), dtype=torch.int32, device="cuda")
    scal = torch.zeros(27, device="cuda")
    kw = dict(nw=2, ns=8, nsx=1, sub_rounds=6)
    with pytest.raises(ValueError, match="mc"):
        t3.march3(scal, mc[:, :100], st, st.int(), st, st, **kw)
    with pytest.raises(ValueError, match="fl"):
        t3.march3(scal, mc, st, st, st, st, **kw)
    with pytest.raises(ValueError, match="whole number"):
        t3.march3(scal, mc, st[:32], st[:32].int(), st[:32], st[:32], **kw)


# ---------------------------------------------------------- the v2 march


@pytest.fixture(scope="module")
def v1_world():
    """The 4-chunk demo world's v1 tables on the card."""
    from voxelraytracing_tpu_torch.ops.wavefront import build_render_grid_host

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = 4
    grids, cells = demo_chunk_grids_host(
        noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    return build_render_grid_host(grids, cells, np.zeros(3, np.int32), w,
                                  demo_materials(), device="cuda")


@pytest.mark.parametrize("budget", [(48, 24), (12, 48)])
@pytest.mark.parametrize("i", range(len(CAMS)))
def test_march2_kernel_equals_plain_version(v1_world, i, budget):
    """Every round of a 256x128 v2 frame, at the renderer's budget (48
    rounds of 2 sub-rounds) and trace_wavefront2's default (12 of 4)."""
    from voxelraytracing_tpu_torch.ops import wavefront2 as t2
    from voxelraytracing_tpu_torch.ops.camera import generate_rays

    cam = CamData.create(*CAMS[i], 70.0, (256, 128))
    o, d = generate_rays(cam, np.zeros(3, np.int32), device="cuda")
    with _Both(t2, "march2") as both:
        res = t2.trace_wavefront2(v1_world, o, d, width=256, height=128,
                                  rounds=budget[0], steps_per_round=budget[1])
    assert [kw["sub_rounds"] for _, kw in both.calls] == \
        [budget[1] // 12] * budget[0]
    assert res.hit.device.type == "cuda"


def test_march2_go_is_program_wide(v1_world):
    """The hand-made round of tests/torch_v2_state.py: the stranded ray of
    a tile that cannot march is demoted because another tile of its
    program marches."""
    from torch_v2_state import STRANDED, go_probe

    from voxelraytracing_tpu_torch.ops import wavefront2 as t2

    args, kw = go_probe(v1_world, "cuda")
    out = _held(t2.march2, t2.march2_ref, args, kw)
    assert int(args[14][STRANDED]) == 1 and int(out[3][STRANDED]) == 0


def test_march2_rejects_bad_inputs(v1_world):
    from torch_v2_state import go_probe

    from voxelraytracing_tpu_torch.ops import wavefront2 as t2

    args, kw = go_probe(v1_world, "cuda")
    bad = list(args)
    bad[9] = args[9][:, :32].contiguous()
    with pytest.raises(ValueError, match="bid"):
        t2.march2(*bad, **kw)
    bad = list(args)
    bad[12] = args[12].float()
    with pytest.raises(ValueError, match="active"):
        t2.march2(*bad, **kw)
    with pytest.raises(ValueError, match="sub-round"):
        t2.march2(*args, **dict(kw, sub_rounds=0))


# ------------------------------------------------------------ the probes


@pytest.fixture(scope="module")
def probe_data():
    """The probe scripts' shapes on the card: a full-range [4096, 128]
    table, [254, 16] and [64, 128] ids, seven [32512, 128] planes of
    random bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from voxelraytracing_tpu_torch.experiments import v3_probe_prims as pp

    rng = np.random.default_rng(11)
    tab = rng.integers(-2 ** 31, 2 ** 31, (pp.NROWS, 128), dtype=np.int64)
    ids = rng.integers(0, pp.NROWS, (pp.NB, 16))
    idx = rng.integers(0, pp.NROWS, (64, 128))
    planes = rng.integers(0, 2 ** 32, (7, pp.T, 128), dtype=np.uint64)
    dev = dict(device="cuda")
    return dict(
        tab=torch.tensor(tab.astype(np.int32), **dev),
        ids=torch.tensor(ids.astype(np.int32), **dev),
        idx=torch.tensor(idx.astype(np.int32), **dev),
        planes=tuple(torch.tensor(p.astype(np.uint32).view(np.float32), **dev)
                     for p in planes))


def _counted(fn, *args, **kw):
    before = fn.launches
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    return out


@pytest.mark.parametrize("nb", [254, 1])
@pytest.mark.parametrize("kind", ["smem", "async", "async_pipelined",
                                  "async_serial"])
def test_row_gather_kernels_equal_plain_version(probe_data, kind, nb):
    """``async`` is the TMA kernel's default (16 rows in flight), the same
    as ``async_pipelined``; ``async_serial`` waits for each row. The
    script's 254 blocks and one block."""
    from voxelraytracing_tpu_torch.experiments import v3_probe_prims as pp

    tab, ids = probe_data["tab"], probe_data["ids"][:nb]
    fn = pp.gather_rows_smem if kind == "smem" else pp.gather_rows_async
    kw = {"async_pipelined": {"pipelined": True},
          "async_serial": {"pipelined": False}}.get(kind, {})
    got = _counted(fn, ids, tab, **kw)
    assert torch.equal(got, pp.gather_rows_ref(ids, tab))


def test_gather_rows_async_rejects_misaligned_table(probe_data):
    """``cp.async.bulk`` needs 16-byte aligned rows: a table that starts
    one word into a flat buffer raises before any launch."""
    from voxelraytracing_tpu_torch.experiments import v3_probe_prims as pp

    tab, ids = probe_data["tab"], probe_data["ids"]
    flat = torch.empty(tab.numel() + 1, dtype=torch.int32, device="cuda")
    off = flat[1:].view(tab.shape)
    off.copy_(tab)
    before = pp.gather_rows_async.launches
    for pipelined in (True, False):
        with pytest.raises(ValueError, match="16-byte aligned"):
            pp.gather_rows_async(ids, off, pipelined=pipelined)
    assert pp.gather_rows_async.launches == before


def test_extract_sum_kernel_equals_plain_version(probe_data):
    """Full-range values: the sum wraps."""
    from voxelraytracing_tpu_torch.experiments import v3_probe_prims as pp

    v = probe_data["tab"][:64]
    got = _counted(pp.extract_sum, v)
    assert torch.equal(got, pp.extract_sum_ref(v))


def test_pass7_kernel_equals_plain_version(probe_data):
    from voxelraytracing_tpu_torch.experiments import v3_probe_prims as pp

    planes = probe_data["planes"]
    got = _counted(pp.pass7, planes)
    for g, p in zip(got, planes):
        assert torch.equal(g.view(torch.int32), p.view(torch.int32))
    short = tuple(p[:1000] for p in planes)  # a ragged last block
    for g, p in zip(_counted(pp.pass7, short), short):
        assert torch.equal(g.view(torch.int32), p.view(torch.int32))


@pytest.mark.parametrize("which", ["vec", "loop"])
def test_subgather_kernels_equal_plain_version(probe_data, which):
    from voxelraytracing_tpu_torch.experiments import v3_probe_subgather as ps

    tab, idx = probe_data["tab"], probe_data["idx"]
    fn, ref = {"vec": (ps.col_gather, ps.col_gather_ref),
               "loop": (ps.row_loop, ps.row_loop_ref)}[which]
    assert torch.equal(_counted(fn, tab, idx), ref(tab, idx))


@pytest.mark.parametrize("blk", [64, 6, 1])
def test_row_loop_kernel_grid_sized_to_output(probe_data, blk):
    """One warp a row, 4 rows a block: 16 blocks, 2 with a half-idle last
    block, and 1; each launch counted once."""
    from voxelraytracing_tpu_torch.experiments import v3_probe_subgather as ps

    tab, idx = probe_data["tab"], probe_data["idx"][:blk].contiguous()
    assert torch.equal(_counted(ps.row_loop, tab, idx),
                       ps.row_loop_ref(tab, idx))


def test_probe_kernels_reject_bad_inputs(probe_data):
    from voxelraytracing_tpu_torch.experiments import v3_probe_prims as pp
    from voxelraytracing_tpu_torch.experiments import v3_probe_subgather as ps

    tab, ids = probe_data["tab"], probe_data["ids"]
    with pytest.raises(ValueError, match="ids"):
        pp.gather_rows_async(ids.cpu(), tab)
    with pytest.raises(ValueError, match="tab"):
        pp.gather_rows_smem(ids, tab.float())
    with pytest.raises(ValueError, match="planes"):
        pp.pass7(probe_data["planes"][:6] + (probe_data["planes"][0].cpu(),))
    with pytest.raises(ValueError, match="idx"):
        ps.col_gather(tab, probe_data["idx"].t())
