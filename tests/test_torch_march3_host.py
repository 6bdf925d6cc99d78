"""The v3 march's CUDA source (``csrc/march3.cu``) run on the CPU against
its plain version, launch by launch.

The card alone runs the kernel (``tests/test_torch_kernels.py``,
``chip_smoke.py``); here its device code is compiled with g++ over a host
stand-in of the CUDA runtime (``tests/torch_cuda_host.h``: a block's
threads as std::threads, the two blocks of a program's cluster together,
``-ffp-contract=off`` as ``--fmad=false``) and driven by
``tests/torch_march3_host.cpp``. The v3 round loop runs on the CPU with
the plain version ``march3_ref``; each of its launches is recorded and
run again through the kernel's source, which must give the same state
planes and wants word for word: camera rays and per-ray bundles, round 0
and the 30-sub-round tail launches, a step cap, a compacted grid's tile
map and ``lookahead=2``, on one and two 64-tile programs of the 4-chunk
demo world.
"""

import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelraytracing_tpu_torch.ops import noise
from voxelraytracing_tpu_torch.ops import wavefront3 as t3
from voxelraytracing_tpu_torch.ops.camera import CamData
from voxelraytracing_tpu_torch.world import demo

from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)
from torch_smem_optin import check_once_per_device

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "voxelraytracing_tpu_torch" / "csrc"
SUN = (1000.0, 2500.0, 500.0)
# tests/torch_v3_scene.py's CAMS[0] and CAMS[2]
CAMS = [((30.0, 45.0, 0.0), (64.0, 75.0, 64.0)),
        ((60.0, 200.0, 0.0), (100.0, 110.0, 30.0))]


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The host build of the kernel's device code."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the CPU")
    out = tmp_path_factory.mktemp("march3_host")
    # the CUDA headers the kernel includes
    for h in ("cuda_runtime.h", "cooperative_groups.h", "cuda_pipeline.h"):
        (out / h).write_text('#include "torch_cuda_host.h"\n')
    exe = out / "torch_march3_host"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-strict-aliasing",
         "-pthread", f"-I{out}", f"-I{TESTS}", f"-I{CSRC}", "-o", str(exe),
         str(TESTS / "torch_march3_host.cpp")],
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    return exe


@pytest.fixture(scope="module")
def world():
    """The 4-chunk demo world (noise seed 7) on the CPU."""
    w = 4
    grids, cells = demo.demo_chunk_grids_host(
        noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    rg = t3.build_render_grid3_host(grids, cells, np.zeros(3, np.int32), w,
                                    demo.demo_materials(), device="cpu")
    return rg, demo.demo_materials()


def _recorded(fn):
    """Run ``fn`` with every march3 call recorded: ``[(args, kw, out)]``,
    ``out`` the plain version's."""
    calls = []
    real = t3.march3

    def rec(*args, **kw):
        out = t3.march3_ref(*args, **kw)
        calls.append((args, kw, out))
        return out

    t3.march3 = rec
    try:
        fn()
    finally:
        t3.march3 = real
    return calls


def _run_host(exe, tmp, args, kw):
    """The kernel on the CPU for one recorded launch -> ``(ts, fl, wa,
    we), want`` as int32 words."""
    scal, mc, ts, fl, wa, we, rays, tmap = args
    T = ts.shape[0]
    inp, outp = tmp / "in.bin", tmp / "out.bin"
    with open(inp, "wb") as f:
        f.write(struct.pack("9i", T, kw["nw"], kw["ns"], kw["nsx"],
                            kw["sub_rounds"], kw["sub_steps"],
                            kw["lookahead"], rays is not None,
                            tmap is not None))
        for x in (scal, mc, rays, tmap, ts, fl, wa, we):
            if x is not None:
                f.write(x.contiguous().numpy().tobytes())
    subprocess.run([str(exe), str(inp), str(outp)], check=True, timeout=120)
    got = np.fromfile(outp, np.int32)
    n = T * 128
    return [got[i * n:(i + 1) * n].reshape(T, 128) for i in range(4)], \
        got[4 * n:].reshape(T, 8)


def _words(x):
    return x.contiguous().view(torch.int32).numpy()


def _held(exe, tmp, calls):
    """Every recorded launch through the kernel's source: the count of
    differing words, and the steps the launches took."""
    bad = steps = 0
    for args, kw, (planes, want) in calls:
        got, gwant = _run_host(exe, tmp, args, kw)
        for g, w in zip(got, planes):
            bad += int((g != _words(w)).sum())
        bad += int((gwant != want.numpy()).sum())
        fl_in = args[3]
        steps += int((((planes[1] >> 5) & 0xFFF) - ((fl_in >> 5) & 0xFFF))
                     .clamp_min(0).sum())
    return bad, steps


def _sub_rounds(calls):
    return [int(a[0][22]) for a, _, _ in calls]


def test_round0_camera_rays_two_programs(host_kernel, world, tmp_path):
    """The first launch of a cold 256x64 frame (two programs): round-0
    init of camera rays from the scalar row."""
    rg, mats = world
    cam = CamData.create(*CAMS[0], 70.0, (256, 64))
    calls = _recorded(lambda: t3.trace_wavefront3(
        rg, np.asarray(cam.pos, np.float32), cam=cam, rounds=1,
        compact=False))
    assert len(calls) == 1 and calls[0][0][1].shape[0] == 2
    assert calls[0][0][0][24] == 1.0  # init
    bad, steps = _held(host_kernel, tmp_path, calls)
    assert bad == 0 and steps > 1000


def test_shadowed_frame_every_launch(host_kernel, world, tmp_path):
    """Every launch of a shadowed 128x64 frame: camera rays, then the
    shadow bundle; past round 5 each launch runs up to 30 sub-rounds."""
    rg, mats = world
    cam = CamData.create(*CAMS[0], 70.0, (128, 64))
    calls = _recorded(lambda: t3.render_frame3(
        rg, cam, mats.color, sun_pos=SUN, shadows=True, rounds=8,
        step_cap=500))
    bundles = [a[6] is not None for a, _, _ in calls]
    assert any(bundles) and not bundles[0]
    assert 30 in _sub_rounds(calls)
    bad, steps = _held(host_kernel, tmp_path, calls)
    assert bad == 0 and steps > 10_000


def test_step_cap(host_kernel, world, tmp_path):
    """A 4-step cap: rays stop mid-flight, still active, at the cap."""
    rg, mats = world
    cam = CamData.create(*CAMS[1], 70.0, (128, 64))
    calls = _recorded(lambda: t3.trace_wavefront3(
        rg, np.asarray(cam.pos, np.float32), cam=cam, rounds=3,
        step_cap=4))
    assert all(a[0][23] == 4.0 for a, _, _ in calls)
    bad, _ = _held(host_kernel, tmp_path, calls)
    assert bad == 0


def test_compacted_tile_map(host_kernel, world, tmp_path):
    """A 256x64 trace whose survivors move to a one-program grid: the
    launches there read their frame tiles from the tile map."""
    rg, mats = world
    cam = CamData.create(*CAMS[1], 70.0, (256, 64))
    calls = _recorded(lambda: t3.trace_wavefront3(
        rg, np.asarray(cam.pos, np.float32), cam=cam, rounds=6,
        compact=(2,)))
    mapped = [a for a, _, _ in calls if a[7] is not None]
    assert mapped and mapped[0][1].shape[0] == 1
    bad, _ = _held(host_kernel, tmp_path, calls)
    assert bad == 0


def test_lookahead_two(host_kernel, world, tmp_path):
    """The want walk two cells ahead (prefetch columns 5-7) on a warm
    128x64 frame: the second frame starts from the first one's token."""
    rg, mats = world
    cam = CamData.create(*CAMS[0], 70.0, (128, 64))
    pos = np.asarray(cam.pos, np.float32)
    _, tok = t3.trace_wavefront3(rg, pos, cam=cam, rounds=2, lookahead=2,
                                 return_cache=True)
    calls = _recorded(lambda: t3.trace_wavefront3(
        rg, pos, cam=cam, rounds=3, lookahead=2, cache=tok))
    assert all(kw["lookahead"] == 2 for _, kw, _ in calls)
    assert any((w[:, 5:] >= 0).any() for _, _, (_, w) in calls)
    bad, _ = _held(host_kernel, tmp_path, calls)
    assert bad == 0


def test_smem_optin_once_per_device(host_kernel):
    """``march3_optin`` (csrc/smem_optin.cuh): both instantiations (camera rays, bundles) opt in to their
    shared memory once on each device, none on a repeat launch, and never
    inside a CUDA-graph capture."""
    check_once_per_device(host_kernel, (0, 1))


def test_band_every_launch(host_kernel, world, tmp_path):
    """Every launch of a band of a taller frame, as
    ``sharded_render_frame3`` draws it: the rows 16 .. 32 of a 128x64
    frame (``scal[21]`` = 16, ``scal[5]`` = 2/64), shadowed, camera rays
    then the band's shadow bundle; the band's frame equals those rows of
    the whole converged frame."""
    rg, mats = world
    cam = CamData.create((45.0, 45.0, 0.0), CAMS[0][1], 70.0, (128, 64))
    origin, lut, row = t3._frame_row3(
        rg, cam, mats.color, sky_color=(0.81, 0.93, 1.0), sun_pos=SUN,
        sun_intensity=4.0, shadow_ambient=0.4, y0=16)
    out = {}

    def band():
        out["band"] = t3._render_frame(
            rg, origin, cam, lut, row, rounds=32, sub_rounds=16,
            step_cap=None, shadows=True, show_steps=False, cache_p=None,
            cache_s=None, compact=True, y0=16, band_height=16)

    calls = _recorded(band)
    assert calls[0][0][0][21] == 16.0 and calls[0][0][0][26] == 2.0
    assert any(a[6] is not None for a, _, _ in calls)
    bad, steps = _held(host_kernel, tmp_path, calls)
    assert bad == 0 and steps > 1000
    full = t3.render_frame3(rg, cam, mats.color, sun_pos=SUN, shadows=True,
                            rounds=32, steps_per_round=128, with_flags=True)
    assert torch.equal(out["band"][0], full[0][16:32])
    assert torch.equal(out["band"][1], full[1][16:32])
