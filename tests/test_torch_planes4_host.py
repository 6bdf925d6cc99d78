"""The state-plane march's CUDA source (``csrc/planes4.cu``) run on the
CPU against its plain version.

The card alone runs the kernels (``tests/test_torch_kernels.py``,
``chip_smoke.py``); here their device code is compiled with g++ over a
host stand-in of the CUDA runtime (``tests/torch_cuda_host.h``: a block's
threads as std::threads, ``-ffp-contract=off`` as ``--fmad=false``) and
driven by ``tests/torch_planes4_host.cpp``. ``march_planes4_kernel``
(four 8x4 pixel groups a 16x8 tile, the shared march step of
``march4_common.cuh``) reads the marks of ``touched4_ref`` and is held to
``march_planes4_ref`` word for word; the mark kernels' own marks to
``touched4_ref``: dense and sparse tables, camera rays, shadow bundles
(inactive rays among them) and a path tracer's bounce bundle, a step cap
of 4, partial tiles, superblocks passed through (a camera outside the
world; a bundle whose rays start in some superblocks only), a camera with
no basis (every direction NaN) and the 34-chunk scene whose sparse
tables hold -1 rows. The camera marks (``touched4_camera_kernel``: a
warp for each 32 tiles, uniform exits, a stop after the first pass in
which a ray starts) also on their uniform exits (a camera outside, a
step cap of 0), on partial blocks and warps of the launcher's grid, and
on a tile whose one starting ray is the last the kernel evaluates;
the bundle marks on a hand-made bundle whose tiles start on their last
ray, or not at all (NaN directions).
"""

import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelraytracing_tpu_torch.ops import noise
from voxelraytracing_tpu_torch.ops import pathtrace3 as p3
from voxelraytracing_tpu_torch.ops import prng
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.ops.camera import CamData
from voxelraytracing_tpu_torch.ops.wavefront3 import build_render_grid3_host
from voxelraytracing_tpu_torch.world import demo
from voxelraytracing_tpu_torch.world.render_grid import RenderGrid3Builder

from chip_smoke import mark_order
from torch_nan_camera import zero_basis
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "voxelraytracing_tpu_torch" / "csrc"
SUN = (1000.0, 2500.0, 500.0)
CAMS = [
    ((30.0, 45.0, 0.0), (64.0, 75.0, 64.0)),
    ((60.0, 200.0, 0.0), (100.0, 110.0, 30.0)),
    ((-20.0, 300.0, 0.0), (64.0, 20.0, 64.0)),
]
OUTSIDE = ((30.0, 45.0, 0.0), (-50.0, 75.0, 64.0))
# a camera 0.0004 voxels inside the world's x = 0 face: rays with dx below
# -0.4 leave the world before EPS_T, so at 64x32 the line between rays that
# start and rays that do not cuts tile 14 (x 32-47, y 24-31) right at the
# pixel the camera marks' kernel evaluates last
FACE = ((0.0, 60.0, 0.0), (0.0004, 60.0, 64.0))
# a camera 0.0004 voxels outside that face, looking along it: its rays
# with dx above 0.4 are inside the world at EPS_T, yet none starts (the
# camera is outside)
FACE_OUT = ((0.0, 180.0, 0.0), (-0.0004, 60.0, 64.0))
# tests/test_torch_sparse.py's 34-chunk scene (tests/test_supercell.py)
W34_CELLS = [(0, 0, 0), (1, 0, 0), (0, 0, 1), (1, 0, 1), (32, 0, 32),
             (33, 0, 33), (16, 8, 16)]
W34_CAMS = [
    ((35.0, 45.0, 0.0), (20.0, 60.0, 20.0)),
    ((70.0, 10.0, 0.0), (528.0, 400.0, 500.0)),
    ((4.2, 45.0, 0.0), (1080.0, 120.0, 1080.0)),
]


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The host build of the kernels' device code."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the CPU")
    out = tmp_path_factory.mktemp("planes4_host")
    # march4_common.cuh includes <cuda_runtime.h>: the stand-in
    (out / "cuda_runtime.h").write_text('#include "torch_cuda_host.h"\n')
    exe = out / "torch_planes4_host"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
         f"-I{out}", f"-I{TESTS}", f"-I{CSRC}", "-o", str(exe),
         str(TESTS / "torch_planes4_host.cpp")],
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    return exe


@pytest.fixture(scope="module")
def worlds():
    """The 4-chunk demo world, dense (prepare_grid4) and sparse (the
    streaming builder), with its materials."""
    w = 4
    mats = demo.demo_materials()
    grids, cells = demo.demo_chunk_grids_host(
        noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    rg = build_render_grid3_host(grids, cells, np.zeros(3, np.int32), w,
                                 mats, device="cpu")
    b = RenderGrid3Builder(w, mats, sparse=True, device="cpu")
    b.set_chunks([(int(c % w), int((c // w) % w), int(c // (w * w)))
                  for c in cells], grids)
    return {False: (rg, t4.prepare_grid4(rg)), True: (b.grid(), b.prepared())}


def _run_host(exe, tmp, tables, rays, h, w, sparse_ns, march=True):
    """Both kernels on the CPU -> (marks, ts, fl, wa, we) as numpy, the
    march reading ``touched4_ref``'s marks; without ``march`` the marks
    alone."""
    scal, gw2, swc, wmp = tables
    nw, ns, gs = t4._world_dims(swc, wmp, sparse_ns)
    marks = t4.touched4_ref(scal, *rays, height=h, width=w)
    inp, outp = tmp / "in.bin", tmp / "out.bin"
    with open(inp, "wb") as f:
        f.write(struct.pack("9i", h, w, nw, ns, gs, int(bool(sparse_ns)),
                            swc.shape[0], int(bool(rays)), int(march)))
        for x in (scal, gw2, swc, wmp, *rays, marks):
            f.write(x.contiguous().numpy().tobytes())
    subprocess.run([str(exe), str(inp), str(outp)], check=True, timeout=120)
    got = outp.read_bytes()
    nm = marks.numel()
    planes = np.frombuffer(got[nm:], np.int32).reshape(4, h, w)
    return np.frombuffer(got[:nm], np.uint8).reshape(marks.shape), planes


def _words_differ(got, want):
    """Words of ``got`` (int32 bits) that differ from ``want``'s bits; two
    NaNs count as equal, whatever their bits (a NaN's payload is the
    platform's: torch's vectorised CPU minimum gives 0xFFFFFFFF)."""
    w = want.contiguous()
    bad = got != w.view(torch.int32).numpy()
    if w.dtype.is_floating_point:
        bad &= ~(np.isnan(got.view(np.float32)) & w.isnan().numpy())
    return int(bad.sum())


def _held(exe, tmp, tables, rays, h, w, sparse_ns=0):
    """The host kernels and the plain versions on one launch: the count of
    differing words and bytes, and the plain planes."""
    scal, gw2, swc, wmp = tables
    marks, planes = _run_host(exe, tmp, tables, rays, h, w, sparse_ns)
    want = t4.march_planes4_ref(scal, gw2, swc, wmp, *rays, height=h,
                                width=w, sparse_ns=sparse_ns)
    bad = int((marks != t4.touched4_ref(scal, *rays, height=h,
                                         width=w).numpy()).sum())
    bad += sum(_words_differ(g, x) for g, x in zip(planes, want))
    return bad, want


def _frame(grid, prep, cam, cap=500):
    """The tables of a frame and its (height, width, sparse_ns)."""
    args, kw = t4.frame_args(grid, cam, demo.demo_materials().color,
                             prepared=prep, sun_pos=SUN, step_cap=cap)
    scal, gw2, _, swc, wmp = args
    return (scal, gw2, swc, wmp), kw["height"], kw["width"], kw["sparse_ns"]


def _camera_and_shadow(exe, tmp, grid, prep, cam, cap=500):
    """Camera planes, then the planes of the frame's shadow bundle: the
    differing words of both and their hit counts."""
    tables, h, w, sp = _frame(grid, prep, cam, cap)
    bad, (ts, fl, _, _) = _held(exe, tmp, tables, (), h, w, sp)
    bundle = t4._shadow_prep4(ts, fl, tables[0].numpy())
    bad2, shadow = _held(exe, tmp, tables, bundle, h, w, sp)
    hits = int(((fl >> 1) & 1).sum()), int(((shadow[1] >> 1) & 1).sum())
    return bad + bad2, hits, bundle


@pytest.mark.parametrize("sparse", [False, True])
def test_camera_rays_and_shadow_bundle(host_kernel, worlds, tmp_path,
                                       sparse):
    """Three cameras at 72x36 (tiles and 8x4 groups cut by the frame's
    edge): the camera planes, then the shadow bundle, whose misses are
    inactive rays."""
    grid, prep = worlds[sparse]
    hits = [0, 0]
    for rot, eye in CAMS:
        bad, h, bundle = _camera_and_shadow(
            host_kernel, tmp_path, grid, prep,
            CamData.create(rot, eye, 70.0, (72, 36)))
        assert bad == 0, (rot, eye)
        assert bool((~bundle[2]).any())
        hits = [a + b for a, b in zip(hits, h)]
    assert min(hits) > 0


@pytest.mark.parametrize("sparse", [False, True])
def test_step_cap_of_four(host_kernel, worlds, tmp_path, sparse):
    """A 4-step cap at 56x28: most rays stop at the cap, mid-march."""
    grid, prep = worlds[sparse]
    bad, _, _ = _camera_and_shadow(
        host_kernel, tmp_path, grid, prep,
        CamData.create(*CAMS[0], 70.0, (56, 28)), cap=4)
    assert bad == 0


def test_superblocks_passed_through(host_kernel, worlds, tmp_path):
    """A camera outside the world (every superblock passed through: zero
    planes, flags -0x30000000), and at 160x72 (four superblocks, the last
    ones partial) a bundle whose rays start in one superblock only: the
    others keep the fresh start."""
    grid, prep = worlds[False]
    tables, h, w, _ = _frame(grid, prep, CamData.create(*OUTSIDE, 70.0,
                                                        (72, 36)))
    bad, (ts, fl, wa, we) = _held(host_kernel, tmp_path, tables, (), h, w)
    assert bad == 0 and bool((fl == -0x30000000).all())
    tables, h, w, _ = _frame(grid, prep, CamData.create(*CAMS[0], 70.0,
                                                        (160, 72)))
    ts, fl, _, _ = t4.march_planes4_ref(*tables, height=h, width=w)
    o, d, act = t4._shadow_prep4(ts, fl, tables[0].numpy())
    act = act.clone()
    act[:, 128:] = False
    act[64:, :] = False
    bad, (ts, fl, _, _) = _held(host_kernel, tmp_path, tables, (o, d, act),
                                h, w)
    assert bad == 0 and bool(act.any())
    assert bool((ts[:, 128:] == t4.EPS_T).all())
    assert bool((fl[:, 128:] == 0).all())


def test_path_tracer_bounce_bundle(host_kernel, worlds, tmp_path):
    """The bounce bundle of a one-bounce path-traced frame (path_trace3's
    v4 route, diffuse draws): scattered directions, misses inactive."""
    grid, prep = worlds[False]
    cam = CamData.create(*CAMS[0], 70.0, (72, 36))
    (scal, gw2, mlut, swc, wmp), (h, w) = p3.pt_inputs(
        grid, cam, demo.demo_materials(), sun_pos=SUN, step_cap=500,
        prepared=prep)
    tables = (scal, gw2, swc, wmp)
    bad, (ts, fl, _, _) = _held(host_kernel, tmp_path, tables, (), h, w)
    sf = [float(x) for x in scal.numpy()]
    pxi, pyi = t4._pixels(h, w, "cpu")
    ts, fl = ts.reshape(-1), fl.reshape(-1)
    mat = p3.matfetch4_ref(fl, mlut)
    base = p3._sample_base(prng.fold_in(prng.split(None, 1)[0], 0))
    rays = p3._bounce_rays(t4._camera_rays(sf, pxi, pyi), ts, (fl >> 2) & 7,
                           mat.scatter, p3.ray_ids(pxi, pyi, *cam.proj_size),
                           base)
    bundle = p3._bundle(rays, ((fl >> 1) & 1) != 0, h, w)
    bad2, planes = _held(host_kernel, tmp_path, tables, bundle, h, w)
    assert bad + bad2 == 0 and bool((~bundle[2]).any())
    assert int(((planes[1] >> 5) & 0xFFF).sum()) > 0


@pytest.mark.parametrize("sparse", [False, True])
def test_nan_direction_takes_no_step(host_kernel, worlds, tmp_path, sparse):
    """A camera whose basis is zero, so each direction is 0/0: no ray
    steps, as in the plain version."""
    grid, prep = worlds[sparse]
    tables, h, w, sp = _frame(
        grid, prep, zero_basis(CamData.create(*CAMS[0], 70.0, (40, 20))))
    bad, (_, fl, _, _) = _held(host_kernel, tmp_path, tables, (), h, w, sp)
    assert bad == 0 and bool((((fl >> 5) & 0xFFF) == 0).all())


def test_34_chunk_scene(host_kernel, tmp_path):
    """Sparse tables past 32 chunks, whose untouched windows give -1 rows
    (read as empty subwindows), 2000-step caps: camera rays and the
    shadow bundle."""
    terrain = np.zeros((32, 32, 32), np.int32)
    terrain[:, :12, :] = demo.STONE
    terrain[:, 12:14, :] = demo.EARTH
    terrain[:, 14, :] = demo.GRASS
    water = np.full((32, 32, 32), demo.WATER, np.int32)
    b = RenderGrid3Builder(34, demo.demo_materials(), sparse=True,
                           device="cpu")
    b.set_chunks(W34_CELLS, np.stack([terrain] * 6 + [water]))
    assert bool((b.prepared().wmeta_pad[:, 0, 64:] == -1).any())
    for rot, eye in W34_CAMS:
        bad, _, _ = _camera_and_shadow(
            host_kernel, tmp_path, b.grid(), b.prepared(),
            CamData.create(rot, eye, 70.0, (48, 24)), cap=2000)
        assert bad == 0, (rot, eye)


def _first_in_order(act, h, w):
    """Per tile (row-major), the position in the camera marks' order
    (``chip_smoke.mark_order``: the representative, then 4 passes of 32)
    of its first ray that starts, or 129."""
    ty, tx = -(-h // 8), -(-w // 16)
    a = torch.nn.functional.pad(act.reshape(h, w).to(torch.uint8),
                                (0, tx * 16 - w, 0, ty * 8 - h))
    a = a.reshape(ty, 8, tx, 16).permute(0, 2, 1, 3).reshape(-1, 128)
    a = a[:, mark_order()].bool()
    return torch.where(a.any(1), a.to(torch.int8).argmax(1), 129)


@pytest.mark.parametrize("case", ["outside", "outside_face", "cap_zero"])
def test_camera_marks_uniform_exit(host_kernel, worlds, tmp_path, case):
    """A camera outside the world, one 0.0004 voxels outside a face (some
    of its rays are inside the world at EPS_T), and a step cap that
    truncates to 0 (scal[23] = 0.75): no ray starts, every mark 0 (the
    launch's uniform exit), every superblock passed through."""
    grid, prep = worlds[False]
    cam = {"outside": OUTSIDE, "outside_face": FACE_OUT}.get(case, CAMS[0])
    tables, h, w, _ = _frame(grid, prep, CamData.create(*cam, 70.0, (72, 36)))
    if case == "cap_zero":
        tables[0][23] = 0.75
        assert t4._step_cap([float(x) for x in tables[0]]) == 0
    if case == "outside_face":
        sf = [float(x) for x in tables[0]]
        rays = t4._camera_rays(sf, *t4._pixels(h, w, "cpu"))
        at = [o + d * t4.EPS_T for o, d in zip(rays[:3], rays[3:])]
        assert bool(((at[0] >= 0) & (at[1] >= 0) & (at[2] >= 0)).any())
    bad, (_, fl, _, _) = _held(host_kernel, tmp_path, tables, (), h, w)
    assert bad == 0 and not t4.touched4_ref(tables[0], height=h,
                                            width=w).any()
    assert bool((fl == -0x30000000).all())


@pytest.mark.parametrize("size", [(24, 12), (250, 100), (504, 252)])
def test_camera_marks_partial_tiles(host_kernel, worlds, tmp_path, size):
    """Frames whose last tile column and row are partial, so invalid, on
    the launcher's grid of 128 tiles a block: 4 tiles (one warp, three
    with no tiles), 208 (two blocks, the second's last warp with none)
    and 1,024 (eight whole blocks)."""
    grid, prep = worlds[False]
    for rot, eye in CAMS[:2]:
        tables, h, w, _ = _frame(grid, prep,
                                 CamData.create(rot, eye, 70.0, size))
        assert (w, h) == size and w % 16 and h % 8
        marks = _run_host(host_kernel, tmp_path, tables, (), h, w, 0,
                          march=False)[0]
        want = t4.touched4_ref(tables[0], height=h, width=w).numpy()
        assert (marks == want).all() and want[:-1, :-1].any()
        assert not want[-1].any() and not want[:, -1].any()


def test_camera_marks_last_ray_in_order(host_kernel, worlds, tmp_path):
    """A tile whose one ray that starts is the last the camera marks'
    kernel evaluates (pass 3, lane 31): the warp must not stop before it.
    Other tiles of the frame are decided by their representative ray, by
    an earlier pass, or start no ray at all."""
    grid, prep = worlds[False]
    tables, h, w, _ = _frame(grid, prep, CamData.create(*FACE, 70.0, (64, 32)))
    act = t4.start_flags(tables[0], height=h, width=w)
    first = _first_in_order(act, h, w)
    assert int(first[14]) == 128
    assert int(act.reshape(4, 8, 4, 16)[3, :, 2].sum()) == 1
    assert {0, 129} <= set(first.tolist())
    assert bool(((first > 0) & (first < 97)).any())
    bad, _ = _held(host_kernel, tmp_path, tables, (), h, w)
    assert bad == 0
    assert t4.touched4_ref(tables[0], height=h, width=w).reshape(-1)[14] == 1


def test_bundle_marks_on_hand_made_rays(host_kernel, worlds, tmp_path):
    """A 48x16 bundle from the world's centre with seeded directions:
    tile (0, 0) holds one active ray, the pixel the camera marks would
    evaluate last; tile (1, 0) only active rays with NaN directions;
    tile (2, 1) only active rays with origins outside the world. Only
    the first tile is marked, so the superblock marches: the rays with
    NaN directions take no step and end at a NaN t, as in the plain
    version."""
    grid, prep = worlds[False]
    tables, _, _, _ = _frame(grid, prep, CamData.create(*CAMS[0], 70.0,
                                                        (48, 16)))
    h, w = 16, 48
    rng = np.random.default_rng(3)
    d = rng.normal(size=(h, w, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.full((h, w, 3), 64.0, np.float32)
    act = np.zeros((h, w), bool)
    act[7, 15] = True
    act[:8, 16:32] = True
    d[:8, 16:32] = np.nan
    act[8:, 32:] = True
    o[8:, 32:, 0] = 200.0
    bundle = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(act))
    bad, (ts, fl, _, _) = _held(host_kernel, tmp_path, tables, bundle, h, w)
    marks = t4.touched4_ref(tables[0], *bundle, height=h, width=w)
    assert bad == 0
    assert marks.tolist() == [[1, 0, 0], [0, 0, 0]]
    assert bool(ts[:8, 16:32].isnan().all())
    assert not bool(((fl[:8, 16:32] >> 5) & 0xFFF).any())


@pytest.mark.parametrize("sparse", [False, True])
def test_camera_marks_and_planes_on_a_band(host_kernel, worlds, tmp_path,
                                           sparse):
    """A band of a taller frame, as ``sharded_render_frame4`` draws it: the
    rows 24 .. 40 of a 72x64 frame (``scal[21]`` = 24, ``scal[5]`` =
    2/64). The camera marks, the camera planes and the planes of the
    band's shadow bundle equal the plain versions word for word; the
    band's camera planes equal those rows of the whole frame's."""
    grid, prep = worlds[sparse]
    cam = CamData.create((45.0, 45.0, 0.0), CAMS[0][1], 70.0, (72, 64))
    row, args, kw = t4._frame_inputs(
        grid, cam, demo.demo_materials().color, sky_color=(0.81, 0.93, 1.0),
        sun_pos=SUN, sun_intensity=4.0, shadow_ambient=0.4, show_steps=False,
        shadows=True, rounds=64, steps_per_round=128, step_cap=500,
        prepared=prep, y0=24, band_height=16)
    assert row[21] == 24.0 and kw["height"] == 16
    tables = (torch.from_numpy(row), args[0], args[2], args[3])
    bad, (ts, fl, wa, we) = _held(host_kernel, tmp_path, tables, (), 16, 72,
                                  kw["sparse_ns"])
    bundle = t4._shadow_prep4(ts, fl, row)
    bad2, shadow = _held(host_kernel, tmp_path, tables, bundle, 16, 72,
                         kw["sparse_ns"])
    assert bad == 0 and bad2 == 0
    hit = (fl >> 1) & 1
    assert bool(hit.any()) and not bool(hit.all())
    assert bool(((shadow[1] >> 1) & 1).any())
    ftables, h, w, sp = _frame(grid, prep, cam)
    full = t4.march_planes4_ref(*ftables, height=h, width=w, sparse_ns=sp)
    for a, b in zip((ts, fl, wa, we), full):
        assert torch.equal(a, b[24:40])
