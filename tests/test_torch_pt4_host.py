"""The one-launch path tracer's CUDA source (``csrc/pathtrace4.cu``) run
on the CPU against its plain version.

The card alone runs the kernel (``tests/test_torch_kernels.py``,
``chip_smoke.py``); here its device code is compiled with g++ over a host
stand-in of the CUDA runtime (``tests/torch_cuda_host.h``: a block's
threads as std::threads, the warp intrinsics among a warp's 32,
``-ffp-contract=off`` as ``--fmad=false``) and driven by
``tests/torch_pt4_host.cpp``. So the kernel's schedule (8x4 pixel groups
a warp on the camera legs; each bounce leg marching the block's queue of
live paths) and its shared march step are held to ``pt4_ref`` on every
tier-1 run, at 0 to 3 bounces with 1 and 2 samples, partial tiles and
a camera outside the world. g++'s libm and torch's CPU kernels may
round exp, pow, log, sin and cos an ulp apart (on the card, whose
transcendentals torch's equal, the kernel equals ``pt4_ref`` bit for bit
where nothing is drawn: ``chip_smoke.py`` phase 12). So where nothing is
drawn (no bounce; the mirror materials of
tests/test_pathtrace4.py, scatter 0) every word is held within rtol 1e-5
(the bar the port's tests hold frames that draw nothing to across two
libms) and most words equal; elsewhere the frame is held to the
path-tracing bar (99% of pixels within 2/255), as Box-Muller's draws
carry an ulp into the scattered directions.
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
from voxelraytracing_tpu_torch.ops import pathtrace4 as p4
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.ops.camera import CamData
from voxelraytracing_tpu_torch.ops.materials import make_material_table
from voxelraytracing_tpu_torch.ops.wavefront3 import build_render_grid3_host
from voxelraytracing_tpu_torch.world import demo

from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "voxelraytracing_tpu_torch" / "csrc"
SUN = (1000.0, 2500.0, 500.0)
CAMS = [
    ((30.0, 45.0, 0.0), (64.0, 75.0, 64.0)),
    ((-20.0, 300.0, 0.0), (64.0, 20.0, 64.0)),
]
OUTSIDE = ((30.0, 45.0, 0.0), (-50.0, 75.0, 64.0))
# the mirror table of tests/test_pathtrace4.py:53-66: scatter 0 for every
# material, so no bounce draws a random number; voxel 1 emits
MIRROR = {
    1: {"color": (0.55, 0.55, 0.55), "state": "solid", "scatter": 0.0,
        "emission": 0.5},
    2: {"color": (0.55, 0.35, 0.15), "state": "solid", "scatter": 0.0},
    3: {"color": (0.30, 0.68, 0.24), "state": "solid", "scatter": 0.0},
    4: {"color": (0.12, 0.30, 0.85), "state": "liquid", "scatter": 0.0},
}
PT_BAR = 0.99  # share of pixels within 2/255 (tools/tpu_correctness.py:190)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The host build of the kernel's device code."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the CPU")
    out = tmp_path_factory.mktemp("pt4_host")
    # march4_common.cuh includes <cuda_runtime.h>: the stand-in
    (out / "cuda_runtime.h").write_text('#include "torch_cuda_host.h"\n')
    exe = out / "torch_pt4_host"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
         f"-I{out}", f"-I{TESTS}", f"-I{CSRC}", "-o", str(exe),
         str(TESTS / "torch_pt4_host.cpp")],
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    return exe


@pytest.fixture(scope="module")
def worlds():
    """The 4-chunk demo terrain with the demo materials and with the
    mirror table."""
    w = 4
    grids, cells = demo.demo_chunk_grids_host(
        noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    out = {}
    for name, mats in (("demo", demo.demo_materials()),
                       ("mirror", make_material_table(256, MIRROR))):
        out[name] = (build_render_grid3_host(
            grids, cells, np.zeros(3, np.int32), w, mats, device="cpu"), mats)
    return out


def _held(exe, tmp, grid, mats, cam, bounces, samples):
    """The kernel on the CPU and the plain version on one frame ->
    (kernel, plain) radiance f32[h, w, 3]."""
    args, (h, w) = p3.pt_inputs(grid, cam, mats, sun_pos=SUN, step_cap=500,
                                key=np.asarray((7, 11), np.uint32))
    scal, gw2, mlut, swc, wmp = args
    nw, ns, gs = t4._world_dims(swc, wmp)
    inv_s = float(np.float32(1.0 / samples))
    inp, outp = tmp / "in.bin", tmp / "out.bin"
    with open(inp, "wb") as f:
        f.write(struct.pack("7i", h, w, nw, ns, gs, bounces, samples))
        f.write(struct.pack("f", inv_s))
        for x in args:
            f.write(x.contiguous().numpy().tobytes())
    subprocess.run([str(exe), str(inp), str(outp)], check=True, timeout=120)
    got = torch.from_numpy(np.fromfile(outp, np.float32).reshape(h, w, 3))
    ref = p4.pt4_ref(*args, height=h, width=w, bounces=bounces,
                     samples=samples)
    return got, ref


def _same(a, b):
    """Share of equal words."""
    return float((a.view(torch.int32) == b.view(torch.int32)).float().mean())


def _bar(a, b):
    return float(((a - b).abs().amax(dim=-1) <= 2.0 / 255.0).float().mean())


@pytest.mark.parametrize("scene, bounces, samples", [
    ("demo", 0, 2), ("mirror", 1, 2), ("mirror", 2, 1), ("mirror", 3, 2)])
def test_where_nothing_is_drawn(host_kernel, worlds, tmp_path,
                                            scene, bounces, samples):
    """No bounce, or mirror materials: every leg end is the plain
    version's arithmetic in its order, so every word is within rtol 1e-5
    of it, and those whose transcendentals round alike are equal. Two
    cameras at 72x36 (tiles cut by the frame's edge stay black)."""
    grid, mats = worlds[scene]
    lit = 0
    for rot, eye in CAMS:
        got, ref = _held(host_kernel, tmp_path, grid, mats,
                         CamData.create(rot, eye, 70.0, (72, 36)), bounces,
                         samples)
        assert torch.allclose(got, ref, rtol=1e-5, atol=0.0), (rot, eye)
        assert _same(got, ref) > 0.95, (rot, eye)
        assert torch.equal(got[:, 64:] == 0, ref[:, 64:] == 0)
        lit += int((ref > 0).sum())
    assert lit > 0


@pytest.mark.parametrize("bounces, samples", [(1, 2), (2, 1)])
def test_diffuse_bounces_within_the_bar(host_kernel, worlds, tmp_path,
                                        bounces, samples):
    """The demo materials scatter: draws go through log/sin/cos, so the
    frame is held to the path-tracing bar, and most words are equal."""
    grid, mats = worlds["demo"]
    for rot, eye in CAMS:
        got, ref = _held(host_kernel, tmp_path, grid, mats,
                         CamData.create(rot, eye, 70.0, (72, 36)), bounces,
                         samples)
        assert bool(torch.isfinite(got).all())
        assert _bar(got, ref) >= PT_BAR, (rot, eye)
        assert _same(got, ref) > 0.9, (rot, eye)


def test_camera_outside_the_world(host_kernel, worlds, tmp_path):
    """A camera outside the world: no leg steps, every whole tile's pixel
    is sky (within rtol 1e-5: pow), the cut tiles black."""
    grid, mats = worlds["demo"]
    got, ref = _held(host_kernel, tmp_path, grid, mats,
                     CamData.create(*OUTSIDE, 70.0, (72, 36)), 1, 1)
    assert torch.allclose(got, ref, rtol=1e-5, atol=0.0)
    assert _same(got, ref) > 0.95
    assert bool((ref[:32, :64] > 0).all()) and bool((got[:, 64:] == 0).all())
