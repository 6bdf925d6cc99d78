"""The v2 march's CUDA source (``csrc/march2.cu``) run on the CPU against
its plain version, round by round.

The card alone runs the kernel (``tests/test_torch_kernels.py``,
``chip_smoke.py``); here its device code is compiled with g++ over a host
stand-in of the CUDA runtime (``tests/torch_cuda_host.h``: a block's
threads as std::threads, the eight blocks of a program's cluster
together, ``-ffp-contract=off`` as ``--fmad=false``) and driven by
``tests/torch_march2_host.cpp``. The v2 round loop runs on the CPU with
the plain version ``march2_ref``; its rounds are recorded and run again
through the kernel's source, which must give the same ten state planes
and wants word for word: round 0 and later rounds of a 256-tile program
of the 4-chunk demo world at the renderer's budget (2 sub-rounds) and at
``trace_wavefront2``'s (4), and the hand-made round of
``tests/torch_v2_state.py`` beside a program whose ``go`` is false.
"""

import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelraytracing_tpu_torch.ops import noise
from voxelraytracing_tpu_torch.ops import wavefront2 as t2
from voxelraytracing_tpu_torch.ops.camera import CamData, generate_rays
from voxelraytracing_tpu_torch.ops.wavefront import build_render_grid_host
from voxelraytracing_tpu_torch.world import demo

from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)
from torch_smem_optin import check_once_per_device
from torch_v2_state import STRANDED, go_probe2

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "voxelraytracing_tpu_torch" / "csrc"
# tests/test_torch_v2.py's CAMS[0] and CAMS[2]
CAMS = [((30.0, 45.0, 0.0), (64.0, 75.0, 64.0)),
        ((60.0, 200.0, 0.0), (100.0, 110.0, 30.0))]


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The host build of the kernel's device code."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the CPU")
    out = tmp_path_factory.mktemp("march2_host")
    # the CUDA headers the kernel includes
    for h in ("cuda_runtime.h", "cooperative_groups.h", "cuda_pipeline.h"):
        (out / h).write_text('#include "torch_cuda_host.h"\n')
    exe = out / "torch_march2_host"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-strict-aliasing",
         "-pthread", f"-I{out}", f"-I{TESTS}", f"-I{CSRC}", "-o", str(exe),
         str(TESTS / "torch_march2_host.cpp")],
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    return exe


@pytest.fixture(scope="module")
def world():
    """The 4-chunk demo world's v1 tables on the CPU."""
    w = 4
    grids, cells = demo.demo_chunk_grids_host(
        noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    return build_render_grid_host(grids, cells, np.zeros(3, np.int32), w,
                                  demo.demo_materials(), device="cpu")


def _rounds(rg, cam, rounds, spr):
    """The ``(args, kw)`` of each march2 call of ``cam``'s 256x128 frame
    (one program) over ``rounds`` rounds of ``spr`` steps."""
    calls = []
    real = t2.march2

    def rec(*args, **kw):
        calls.append((args, kw))
        return t2.march2_ref(*args, **kw)

    origin, dirs = generate_rays(CamData.create(*cam, 70.0, (256, 128)),
                                 np.zeros(3, np.int32), device="cpu")
    t2.march2 = rec
    try:
        t2.trace_wavefront2(rg, origin, dirs, width=256, height=128,
                            rounds=rounds, steps_per_round=spr)
    finally:
        t2.march2 = real
    return calls


def _words(x):
    return x.contiguous().view(torch.int32).numpy()


def _run_host(exe, tmp, args, kw):
    """The kernel on the CPU for one call's ``(args, kw)`` -> its twelve
    outputs as int32 words."""
    T = args[1].shape[0]
    inp, outp = tmp / "in.bin", tmp / "out.bin"
    with open(inp, "wb") as f:
        f.write(struct.pack("4i", T, kw["nb"], kw["bg_side"],
                            kw["sub_rounds"]))
        for x in args:
            f.write(x.contiguous().numpy().tobytes())
    subprocess.run([str(exe), str(inp), str(outp)], check=True, timeout=120)
    got = np.fromfile(outp, np.int32)
    n = T * 128
    planes = [got[i * n:(i + 1) * n].reshape(T, 128) for i in range(10)]
    want_win = got[10 * n:10 * n + T].reshape(T, 1)
    return planes + [want_win, got[10 * n + T:].reshape(T, 16)]


def _held(exe, tmp, args, kw):
    """One call through the kernel's source against the plain version:
    the count of differing words, the plain outputs, and the steps the
    call took."""
    want = t2.march2_ref(*args, **kw)
    got = _run_host(exe, tmp, args, kw)
    bad = sum(int((g != _words(w)).sum()) for g, w in zip(got, want))
    steps = int((want[9] - args[20]).clamp_min(0).sum())
    return bad, want, steps


@pytest.mark.parametrize("cam", range(len(CAMS)))
def test_round0_renderer_budget(host_kernel, world, tmp_path, cam):
    """Round 0 of a frame at the renderer's budget (2 sub-rounds of 12):
    the camera's window only in the cache."""
    args, kw = _rounds(world, CAMS[cam], 1, 24)[0]
    assert kw["sub_rounds"] == 2
    bad, _, steps = _held(host_kernel, tmp_path, args, kw)
    assert bad == 0 and steps > 1000


def test_later_rounds(host_kernel, world, tmp_path):
    """Rounds 3 and 5 of a frame at the renderer's budget, with served
    windows and bricks in the cache: rays descend to voxel level, hit and
    leave their bricks."""
    calls = _rounds(world, CAMS[0], 6, 24)
    for args, kw in (calls[3], calls[5]):
        assert int((args[9] >= 0).sum()) > 0  # bricks served
        bad, want, steps = _held(host_kernel, tmp_path, args, kw)
        assert bad == 0 and steps > 0
    assert int(want[2].sum()) > 0  # hits


def test_trace_default_budget(host_kernel, world, tmp_path):
    """Round 2 of trace_wavefront2's default budget (4 sub-rounds of 12)."""
    calls = _rounds(world, CAMS[1], 3, 48)
    args, kw = calls[2]
    assert kw["sub_rounds"] == 4
    bad, _, steps = _held(host_kernel, tmp_path, args, kw)
    assert bad == 0 and steps > 0


def test_go_is_program_wide(host_kernel, world, tmp_path):
    """The two programs of tests/torch_v2_state.py's ``go_probe2``: in the
    first the stepper, in another block of the program's cluster than the
    stranded ray, marches, so every ray of the program takes the steps and
    the stranded ray is demoted (then stops stepping); the second has no
    stepper, its ``go`` is false, and its stranded ray stays at voxel
    level."""
    args, kw = go_probe2(world, "cpu")
    bad, want, _ = _held(host_kernel, tmp_path, args, kw)
    assert bad == 0
    lvl = want[3]
    assert int(lvl[STRANDED]) == 0 and int(lvl[256 + STRANDED[0],
                                               STRANDED[1]]) == 1


def test_smem_optin_once_per_device(host_kernel):
    """``march2_optin`` (csrc/smem_optin.cuh): the kernel opts in to its
    shared memory once on each device, none on a repeat launch, and never
    inside a CUDA-graph capture."""
    check_once_per_device(host_kernel, (0,))
