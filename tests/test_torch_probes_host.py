"""The probe kernels ``col_gather`` and ``extract_sum`` (``csrc/probes3.cu``)
run on the CPU against their plain versions.

The card alone runs the kernels (``tests/test_torch_kernels.py``,
``chip_smoke.py`` phase 29); here their device code is compiled with g++
over the host stand-in of the CUDA runtime (``tests/torch_cuda_host.h``,
whose ``__reduce_add_sync`` sums over a warp's threads) and driven by
``tests/torch_probes_host.cpp`` at the launchers' grids. Each output word
must equal the plain version's: at the probe scripts' shapes and inputs,
on full-range random words, with a partial last block, and with a sum that
wraps past 2^31 as JAX's int32 sum does.
"""

import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelraytracing_tpu_torch.experiments import v3_probe_prims as pp
from voxelraytracing_tpu_torch.experiments import v3_probe_subgather as ps

from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "voxelraytracing_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def host_probes(tmp_path_factory):
    """The host build of the two kernels' device code."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' source for the CPU")
    out = tmp_path_factory.mktemp("probes_host")
    # probes3.cu includes <cuda_runtime.h>: the stand-in
    (out / "cuda_runtime.h").write_text('#include "torch_cuda_host.h"\n')
    exe = out / "torch_probes_host"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", f"-I{out}", f"-I{TESTS}",
         f"-I{CSRC}", "-o", str(exe), str(TESTS / "torch_probes_host.cpp")],
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    return exe


def _run_host(exe, tmp, which, header, arrays, out_shape):
    """Kernel ``which`` on the CPU: int32 ``header`` then ``arrays`` in,
    an i32 array of ``out_shape`` out."""
    inp, outp = tmp / "in.bin", tmp / "out.bin"
    with open(inp, "wb") as f:
        f.write(struct.pack(f"{len(header)}i", *header))
        for a in arrays:
            f.write(a.contiguous().numpy().tobytes())
    subprocess.run([str(exe), which, str(inp), str(outp)], check=True,
                   timeout=60)
    return torch.from_numpy(np.fromfile(outp, np.int32).reshape(out_shape))


def _words(rng, *shape):
    """Full-range int32 words."""
    return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape,
                                         dtype=np.int64).astype(np.int32))


def _col_inputs(case):
    if case == "script":
        return ps.probe_inputs("cpu")
    rng = np.random.default_rng(5)
    blk = {"random": ps.BLK, "ragged": 6, "one_row": 1}[case]
    idx = rng.integers(0, pp.NROWS, (blk, pp.ROW)).astype(np.int32)
    return _words(rng, pp.NROWS, pp.ROW), torch.from_numpy(idx)


@pytest.mark.parametrize("case", ["script", "random", "ragged", "one_row"])
def test_col_gather_source_equals_plain(host_probes, tmp_path, case):
    """The script's [4096, 128] arange table and [64, 128] ids; random
    words at 64 rows; 6 rows (a grid whose second block is half idle); one
    row."""
    tab, idx = _col_inputs(case)
    blk = idx.shape[0]
    got = _run_host(host_probes, tmp_path, "col_gather", (tab.shape[0], blk),
                    (tab, idx), (blk, pp.ROW))
    want = ps.col_gather(tab, idx)
    assert torch.equal(got, want)


def _sum_input(case):
    rng = np.random.default_rng(9)
    if case == "script":
        return ps.probe_inputs("cpu")[0][:pp.BLK]
    if case == "wraps":
        v = torch.full((pp.BLK, pp.ROW), 2 ** 31 - 1 - 1000, dtype=torch.int32)
        v[:, 1:] = _words(rng, pp.BLK, pp.ROW - 1)
        return v
    if case == "random":
        return _words(rng, pp.BLK, pp.ROW)
    return _words(rng, pp.NROWS, pp.ROW)  # "tall": only rows 0-63 count


@pytest.mark.parametrize("case", ["script", "wraps", "random", "tall"])
def test_extract_sum_source_equals_plain(host_probes, tmp_path, case):
    """The script's input (tab[:64] of the arange table); 64 words just
    under 2^31, whose sum wraps; full-range words; a 4096-row input, of
    which the kernel sums rows 0-63 only."""
    v = _sum_input(case)
    got = _run_host(host_probes, tmp_path, "extract_sum", (v.shape[0],),
                    (v,), (8, pp.ROW))
    want = pp.extract_sum(v)
    assert torch.equal(got, want)
    if case == "wraps":
        assert int(v[:pp.BLK, 0].to(torch.int64).sum()) >= 2 ** 31
