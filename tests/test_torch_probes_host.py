"""The probe kernels ``col_gather``, ``row_loop``, ``extract_sum``,
``gather_rows_smem`` and ``gather_rows_async`` (``csrc/probes3.cu``) run
on the CPU against their plain versions.

The card alone runs the kernels (``tests/test_torch_kernels.py``,
``chip_smoke.py`` phase 29); here their device code is compiled with g++
over the host stand-in of the CUDA runtime (``tests/torch_cuda_host.h``,
whose ``__reduce_add_sync`` sums over a warp's threads) and driven by
``tests/torch_probes_host.cpp`` at the launchers' grids. That file also
stands in for the TMA bulk copies (a ``memcpy``) and the mbarrier (a
parity, arrivals and bytes outstanding) of ``gather_rows_async``, and
aborts where the card would hang: a wait on a phase whose bytes were not
all copied, or on the wrong parity. Each output word must equal the plain
version's: at the probe scripts' shapes and inputs, on full-range random
words, with a partial last block, with one block, with repeated ids and
the first and last rows, and with a sum that wraps past 2^31 as JAX's
int32 sum does.
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
    r = subprocess.run([str(exe), which, str(inp), str(outp)],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
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


@pytest.mark.parametrize("case", ["script", "random", "ragged", "one_row"])
def test_row_loop_source_equals_plain(host_probes, tmp_path, case):
    """The script's inputs; random words at 64 rows (16 blocks of 4
    warps); 6 rows (a second block with two idle warps); one row."""
    tab, idx = _col_inputs(case)
    blk = idx.shape[0]
    assert ps.row_loop_blocks(blk) == {64: 16, 6: 2, 1: 1}[blk]
    got = _run_host(host_probes, tmp_path, "row_loop", (tab.shape[0], blk),
                    (tab, idx), (blk, pp.ROW))
    want = ps.row_loop(tab, idx)
    assert torch.equal(got, want)


def _gather_inputs(case):
    if case == "script":
        x = pp.probe_inputs("cpu")
        return x["tab"], x["ids"]
    rng = np.random.default_rng(7)
    nb = {"random": pp.NB, "one_block": 1}[case]
    ids = rng.integers(0, pp.NROWS, (nb, pp.IDS)).astype(np.int32)
    return _words(rng, pp.NROWS, pp.ROW), torch.from_numpy(ids)


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["in_flight", "serial"])
@pytest.mark.parametrize("case", ["script", "random", "one_block"])
def test_gather_rows_async_source_equals_plain(host_probes, tmp_path, case,
                                               pipelined):
    """Both modes (16 rows armed on one phase, or each row armed and waited
    at a parity that flips): the script's [4096, 128] arange table and
    [254, 16] ids; full-range words; one block."""
    tab, ids = _gather_inputs(case)
    nb = ids.shape[0]
    got = _run_host(host_probes, tmp_path, "gather_rows_async",
                    (tab.shape[0], nb, int(pipelined)), (tab, ids),
                    (nb, pp.IDS, pp.ROW))
    want = pp.gather_rows_async(ids, tab, pipelined=pipelined)
    assert torch.equal(got, want)


def _smem_inputs(case):
    if case in ("script", "random", "one_block"):
        return _gather_inputs(case)
    rng = np.random.default_rng(8)
    if case == "repeated":  # three rows, each many times in a block
        ids = rng.integers(0, 3, (32, pp.IDS)) * 1000
    else:  # "edges": rows 0 and rows - 1 only
        ids = rng.integers(0, 2, (32, pp.IDS)) * (pp.NROWS - 1)
    return _words(rng, pp.NROWS, pp.ROW), torch.from_numpy(ids.astype(np.int32))


@pytest.mark.parametrize("case", ["script", "random", "one_block",
                                  "repeated", "edges"])
def test_gather_rows_smem_source_equals_plain(host_probes, tmp_path, case):
    """A warp for each four rows, their ids loaded by every lane: the
    script's arange table and [254, 16] ids; full-range words at 254
    blocks and at one; ids repeating three rows; ids 0 and rows - 1
    only."""
    tab, ids = _smem_inputs(case)
    nb = ids.shape[0]
    got = _run_host(host_probes, tmp_path, "gather_rows_smem",
                    (tab.shape[0], nb), (tab, ids), (nb, pp.IDS, pp.ROW))
    assert torch.equal(got, pp.gather_rows_smem(ids, tab))
    if case == "edges":
        assert set(ids.unique().tolist()) == {0, pp.NROWS - 1}


@pytest.mark.parametrize("misuse", ["bar_short", "bar_long", "bar_parity"])
def test_host_barrier_aborts_where_the_card_would_hang(host_probes, misuse):
    """The stand-in barrier refuses what would hang the card or let a wait
    pass early: 1 KB armed and 512 bytes copied, 512 armed and 1 KB
    copied, a second row waited on the first row's parity."""
    r = subprocess.run([str(host_probes), misuse], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode != 0
    assert "the card would hang" in r.stderr
    want = {"bar_short": "has not completed", "bar_long": "more bytes",
            "bar_parity": "has not completed"}[misuse]
    assert want in r.stderr


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
