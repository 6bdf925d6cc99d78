"""The fused frame's CUDA source (``csrc/march4.cu``) run on the CPU against
its plain version.

The card alone runs the kernel (``tests/test_torch_kernels.py``,
``chip_smoke.py``); here its device code is compiled with g++ over a host
stand-in of the CUDA runtime (``tests/torch_cuda_host.h``: a block's
threads as std::threads, ``-ffp-contract=off`` as ``--fmad=false``) and
driven by ``tests/torch_march4_host.cpp``. So the kernel's schedule (8x4
pixel groups a warp), its march step and its shadow leg are held to
``march_fused4_ref`` word for word on every tier-1 run: dense and sparse
tables, shadows, step caps, the heatmap, partial pixel groups, a camera
outside the world and the 34-chunk scene whose sparse tables hold -1
rows.
"""

import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelraytracing_tpu_torch.ops import noise
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.ops.camera import CamData
from voxelraytracing_tpu_torch.ops.wavefront3 import build_render_grid3_host
from voxelraytracing_tpu_torch.world import demo
from voxelraytracing_tpu_torch.world.render_grid import RenderGrid3Builder

from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "voxelraytracing_tpu_torch" / "csrc"
SUN = (1000.0, 2500.0, 500.0)
CAMS = [
    ((30.0, 45.0, 0.0), (64.0, 75.0, 64.0)),
    ((5.0, 120.0, 0.0), (20.0, 40.0, 100.0)),
    ((60.0, 200.0, 0.0), (100.0, 110.0, 30.0)),
    ((-20.0, 300.0, 0.0), (64.0, 20.0, 64.0)),
    ((30.0, 45.0, 0.0), (-50.0, 75.0, 64.0)),  # outside the world
]
# tests/test_torch_sparse.py's 34-chunk scene (tests/test_supercell.py)
W34_CELLS = [(0, 0, 0), (1, 0, 0), (0, 0, 1), (1, 0, 1), (32, 0, 32),
             (33, 0, 33), (16, 8, 16)]
W34_CAMS = [
    ((35.0, 45.0, 0.0), (20.0, 60.0, 20.0)),
    ((14.5, 225.0, 0.0), (10.0, 400.0, 10.0)),
    ((70.0, 10.0, 0.0), (528.0, 400.0, 500.0)),
    ((4.2, 45.0, 0.0), (1080.0, 120.0, 1080.0)),
]


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The host build of the kernel's device code."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the CPU")
    out = tmp_path_factory.mktemp("march4_host")
    # march4_common.cuh includes <cuda_runtime.h>: the stand-in
    (out / "cuda_runtime.h").write_text('#include "torch_cuda_host.h"\n')
    exe = out / "torch_march4_host"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
         f"-I{out}", f"-I{TESTS}", f"-I{CSRC}", "-o", str(exe),
         str(TESTS / "torch_march4_host.cpp")],
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    return exe


def _run_host(exe, tmp, args, kw):
    """The kernel on the CPU for ``frame_args``' ``(args, kw)`` ->
    (packed, flags) as numpy i32[h, w]."""
    scal, gw2, lut, swc, wmp = args
    nw, ns, gs = t4._world_dims(swc, wmp, kw["sparse_ns"])
    h, w = kw["height"], kw["width"]
    inp, outp = tmp / "in.bin", tmp / "out.bin"
    with open(inp, "wb") as f:
        f.write(struct.pack("9i", h, w, nw, ns, gs, int(kw["show_steps"]),
                            int(kw["shadows"]), int(bool(kw["sparse_ns"])),
                            swc.shape[0]))
        f.write(struct.pack("f", float(np.float32(kw["max_steps"]))))
        for x in (scal, gw2, lut, swc, wmp):
            f.write(x.contiguous().numpy().tobytes())
    subprocess.run([str(exe), str(inp), str(outp)], check=True, timeout=120)
    return np.fromfile(outp, np.int32).reshape(2, h, w)


def _held(exe, tmp, grid, prep, cam, **kw):
    """The host kernel and the plain version on one frame: the count of
    differing words (flags and packed) and the frame's hit pixels."""
    args, fkw = t4.frame_args(grid, cam, demo.demo_materials().color,
                              prepared=prep, sun_pos=SUN, **kw)
    got = _run_host(exe, tmp, args, fkw)
    packed, flags = t4.march_fused4_ref(*args, **fkw)
    bad = int((got[0] != packed.numpy()).sum()) \
        + int((got[1] != flags.numpy()).sum())
    return bad, int(((flags >> 1) & 1).sum())


@pytest.fixture(scope="module")
def worlds():
    """The 4-chunk demo world, dense (prepare_grid4) and sparse (the
    streaming builder)."""
    w = 4
    grids, cells = demo.demo_chunk_grids_host(
        noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    rg = build_render_grid3_host(grids, cells, np.zeros(3, np.int32), w,
                                 demo.demo_materials(), device="cpu")
    b = RenderGrid3Builder(w, demo.demo_materials(), sparse=True,
                           device="cpu")
    b.set_chunks([(int(c % w), int((c // w) % w), int(c // (w * w)))
                  for c in cells], grids)
    return {False: (rg, t4.prepare_grid4(rg)), True: (b.grid(), b.prepared())}


@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
def test_kernel_source_equals_plain_version(host_kernel, worlds, tmp_path,
                                            sparse, shadows):
    """Five cameras at 72x36 and 100x52 (the last 8x4 groups cut by the
    frame's edge), step caps 500 and 20."""
    grid, prep = worlds[sparse]
    hits = 0
    for rot, eye in CAMS:
        for size, cap in (((72, 36), 500), ((100, 52), 20)):
            bad, h = _held(host_kernel, tmp_path, grid, prep,
                           CamData.create(rot, eye, 70.0, size),
                           shadows=shadows, step_cap=cap)
            assert bad == 0, (rot, eye, size, cap)
            hits += h
    assert hits > 0


def test_kernel_source_heatmap(host_kernel, worlds, tmp_path):
    """The step heatmap (show_steps) with a cap of 20."""
    grid, prep = worlds[False]
    rot, eye = CAMS[0]
    bad, hits = _held(host_kernel, tmp_path, grid, prep,
                      CamData.create(rot, eye, 70.0, (64, 32)),
                      show_steps=True, step_cap=20)
    assert bad == 0 and hits > 0


def test_kernel_source_on_a_34_chunk_scene(host_kernel, tmp_path):
    """Sparse tables past 32 chunks, whose untouched windows give -1 rows
    (read as empty subwindows), 2000-step caps, shadows on."""
    terrain = np.zeros((32, 32, 32), np.int32)
    terrain[:, :12, :] = demo.STONE
    terrain[:, 12:14, :] = demo.EARTH
    terrain[:, 14, :] = demo.GRASS
    water = np.full((32, 32, 32), demo.WATER, np.int32)
    b = RenderGrid3Builder(34, demo.demo_materials(), sparse=True,
                           device="cpu")
    b.set_chunks(W34_CELLS, np.stack([terrain] * 6 + [water]))
    assert bool((b.prepared().wmeta_pad[:, 0, 64:] == -1).any())
    steps = 0
    for rot, eye in W34_CAMS:
        args, kw = t4.frame_args(b.grid(), CamData.create(rot, eye, 70.0,
                                                          (64, 32)),
                                 demo.demo_materials().color,
                                 prepared=b.prepared(), sun_pos=SUN,
                                 shadows=True, step_cap=2000)
        got = _run_host(host_kernel, tmp_path, args, kw)
        packed, flags = t4.march_fused4_ref(*args, **kw)
        assert np.array_equal(got[0], packed.numpy())
        assert np.array_equal(got[1], flags.numpy())
        steps += int(((flags >> 5) & 0xFFF).sum())
    assert steps > 10_000  # long rays across the empty windows
