"""Gather probe on the card: a per-lane gather against looped row reads
on a [4096, 128] table, the shape of the TPU march's cache of subwindow
rows.

Port of ``experiments/v3_probe_subgather.py``, the TPU probe script. Its
two Pallas kernels become kernels of ``csrc/probes3.cu``; each wrapper
launches its kernel on CUDA tensors and runs its plain PyTorch version on
CPU tensors. The probe's 256 programs all write the same [64, 128] block,
which on the TPU's sequential grid repeats one program's work:

  * :func:`col_gather` (``vec``, ``k_gather``): ``out[j, l] =
    tab[idx[j, l], l]``, computed once, by a grid sized to the output;
    plain version :func:`col_gather_ref`.
  * :func:`row_loop` (``loop``, ``k_loop``): ``out[j, :] = tab[idx[j, 0],
    :]``, still in the probe's ``PROGRAMS`` blocks; plain version
    :func:`row_loop_ref`.

    python -m voxelraytracing_tpu_torch.experiments.v3_probe_subgather vec|loop
"""

import sys

import numpy as np
import torch

from .. import _build
from ..ops.wavefront4 import _check, _device_of, _run
from .v3_probe_prims import NROWS, ROW, cuda_ms

BLK = 64
PROGRAMS = 256  # row_loop's blocks, the probe's programs
COL_BLOCK_WORDS = 4 * 128  # a col_gather block: 128 threads, 4 words each


def col_gather_blocks(blk):
    """``col_gather_kernel``'s grid for ``blk`` output rows."""
    return -(-blk * ROW // COL_BLOCK_WORDS)


def col_gather_ref(tab, idx):
    """``out[j, l] = tab[idx[j, l], l]`` -> i32[blk, 128]."""
    return tab[idx.long(), torch.arange(ROW, device=tab.device)]


def row_loop_ref(tab, idx):
    """``out[j, :] = tab[idx[j, 0], :]`` -> i32[blk, 128], one row at a
    time."""
    return torch.stack([tab[i] for i in idx[:, 0].tolist()])


def _run_probe(fn, name, tab, idx, *grid):
    dev = _device_of(tab, name)
    _check(dev, [("tab", tab, torch.int32, (tab.shape[0], ROW)),
                 ("idx", idx, torch.int32, (idx.shape[0], ROW))])
    if dev.type == "cpu":
        return None
    out = torch.empty(idx.shape, dtype=torch.int32, device=dev)
    _run(dev, name, getattr(_build.load("probes3"), name + "_launch"),
         tab.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], *grid)
    fn.launches += 1
    return out


def col_gather(tab, idx):
    """``vec``: ``tab`` i32[rows, 128] gathered lane by lane by ``idx``
    i32[blk, 128] -> i32[blk, 128]: ``col_gather_kernel``, one thread for
    each 4 output words (one 16-byte load of ids, 4 gathers in flight, one
    16-byte store), on CUDA; :func:`col_gather_ref` on the CPU."""
    out = _run_probe(col_gather, "col_gather", tab, idx)
    return col_gather_ref(tab, idx) if out is None else out


col_gather.launches = 0  # kernel launches since the last reset


def row_loop(tab, idx):
    """``loop``: the rows ``tab[idx[j, 0]]`` -> i32[blk, 128]:
    ``row_loop_kernel`` in ``PROGRAMS`` blocks, one warp a row, on CUDA;
    :func:`row_loop_ref` on the CPU."""
    out = _run_probe(row_loop, "row_loop", tab, idx, PROGRAMS)
    return row_loop_ref(tab, idx) if out is None else out


row_loop.launches = 0  # kernel launches since the last reset

KERNELS = (col_gather, row_loop)


def probe_inputs(device="cuda", seed=0):
    """The probe script's inputs, made with NumPy from ``seed``: the
    [4096, 128] arange table and [64, 128] ids."""
    rng = np.random.default_rng(seed)
    tab = torch.arange(NROWS * ROW, dtype=torch.int32).reshape(NROWS, ROW)
    idx = torch.from_numpy(rng.integers(0, NROWS, (BLK, ROW)).astype(np.int32))
    return tab.to(device), idx.to(device)


def main(argv):
    """``vec`` or ``loop`` on the card at the script's shapes: print
    whether the result has the per-lane and the row semantics, as the
    probe script does, and the time of a call with its grid; return it in
    ms."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA card")
    which = argv[0] if argv else ""
    kern = {"vec": col_gather, "loop": row_loop}.get(which)
    if kern is None:
        raise SystemExit("usage: v3_probe_subgather vec|loop")
    tab, idx = probe_inputs()
    r = kern(tab, idx)
    print(f"correct(vec semantics): {torch.equal(r, col_gather_ref(tab, idx))} "
          f"correct(row semantics): {torch.equal(r, row_loop_ref(tab, idx))}")
    ms = cuda_ms(lambda: kern(tab, idx))
    blocks = col_gather_blocks(BLK) if kern is col_gather else PROGRAMS
    print(f"{which}: OK {ms * 1e3:.2f} us/call ({blocks} blocks)", flush=True)
    return ms


if __name__ == "__main__":
    main(sys.argv[1:])
