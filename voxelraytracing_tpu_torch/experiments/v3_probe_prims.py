"""Primitive probes on the card: row gathers by scalar ids, async row
copies, a lane extract and a pass-through copy of seven state planes.

Port of ``experiments/v3_probe_prims.py``, the TPU probe script. Its
Pallas kernels become the hand-written kernels of ``csrc/probes3.cu``
(the source says what each probes on Hopper); P4, an XLA gather there,
is one torch indexing call here, timed as a library call. Each wrapper
launches its kernel on CUDA tensors and runs its plain PyTorch version on
CPU tensors:

  * :func:`gather_rows_smem` (P1, ``k_smem``) and :func:`gather_rows_async`
    (P2, ``k_dma``, by TMA bulk copies on an mbarrier):
    ``out[i, k, :] = tab[ids[i, k], :]``; plain version
    :func:`gather_rows_ref`. As written, ``k_smem`` does not trace: its out
    block is ``(1, 16, 128)`` and ``o_ref[pl.ds(k, 1), :]`` indexes the
    leading axis of size 1, so on the TPU its ``try`` printed "P1 FAIL".
    Its intended function is the one ``k_dma`` computes, which both
    kernels compute here.
  * :func:`extract_sum` (P3, ``k_extract``): the wrapping int32 sum of
    ``v[0:64, 0]`` broadcast to ``(8, 128)``; plain :func:`extract_sum_ref`.
  * :func:`pass7` (P5, ``k_pass``): seven f32 planes copied through; plain
    :func:`pass7_ref`.

The gathers and the pass-through run as many blocks as the probe has
programs (254 gather blocks, 508 pass-through blocks of 64 rows), since
each of those programs does its own part of the work. The extract's 254
programs all wrote the same block, which on the TPU's sequential grid
repeated one program's work; its kernel computes the block once.

    python -m voxelraytracing_tpu_torch.experiments.v3_probe_prims
"""

import statistics

import numpy as np
import torch

from .. import _build
from ..ops.wavefront4 import _check, _device_of, _run

BLK = 64
NROWS = 4096
NB = 254
IDS = 16      # rows a gather block
T = 32512     # rows of a state plane (P5)
ROW = 128


def gather_rows_ref(ids, tab):
    """``out[i, k, :] = tab[ids[i, k], :]`` -> i32[nb, 16, 128], one row
    at a time."""
    rows = [tab[i] for i in ids.reshape(-1).tolist()]
    return torch.stack(rows).reshape(ids.shape[0], IDS, tab.shape[1])


def _gather_checks(ids, tab, name):
    dev = _device_of(tab, name)
    _check(dev, [("ids", ids, torch.int32, (ids.shape[0], IDS)),
                 ("tab", tab, torch.int32, (tab.shape[0], ROW))])
    return dev


def gather_rows_smem(ids, tab):
    """P1: ``tab`` i32[rows, 128] gathered by ``ids`` i32[nb, 16] ->
    i32[nb, 16, 128]: ``gather_rows_smem_kernel``, one block of ids staged
    in shared memory, one warp a row, on CUDA; :func:`gather_rows_ref` on
    the CPU."""
    dev = _gather_checks(ids, tab, "gather_rows_smem")
    if dev.type == "cpu":
        return gather_rows_ref(ids, tab)
    out = torch.empty((ids.shape[0], IDS, ROW), dtype=torch.int32, device=dev)
    _run(dev, "gather_rows_smem", _build.load("probes3").gather_rows_smem_launch,
         ids.data_ptr(), tab.data_ptr(), out.data_ptr(), ids.shape[0])
    gather_rows_smem.launches += 1
    return out


gather_rows_smem.launches = 0  # kernel launches since the last reset


def gather_rows_async(ids, tab, *, pipelined=True):
    """P2: the same function as :func:`gather_rows_smem` by TMA bulk row
    copies (``cp.async.bulk``, 512 bytes each) into shared memory that
    complete on an mbarrier, and one bulk store of each block's 16 rows
    (``gather_rows_async_kernel``): all 16 in flight at once, or with
    ``pipelined=False`` each waited for before the next is issued (the
    probe's ``start(); wait()``); :func:`gather_rows_ref` on the CPU. The
    bulk copies need ``tab`` and the output 16-byte aligned: a ``tab``
    that is not raises, on either device (the output is the wrapper's own
    allocation, which torch aligns to 512 bytes)."""
    dev = _gather_checks(ids, tab, "gather_rows_async")
    if tab.data_ptr() % 16:
        raise ValueError("tab: gather_rows_async copies rows with "
                         "cp.async.bulk, which needs a 16-byte aligned "
                         f"table; this one starts at {tab.data_ptr():#x}")
    if dev.type == "cpu":
        return gather_rows_ref(ids, tab)
    out = torch.empty((ids.shape[0], IDS, ROW), dtype=torch.int32, device=dev)
    _run(dev, "gather_rows_async",
         _build.load("probes3").gather_rows_async_launch, ids.data_ptr(),
         tab.data_ptr(), out.data_ptr(), ids.shape[0], int(bool(pipelined)))
    gather_rows_async.launches += 1
    return out


gather_rows_async.launches = 0  # kernel launches since the last reset


def extract_sum_ref(v):
    """The int32 sum of ``v[0:64, 0]``, wrapping as JAX's int32 sum does,
    broadcast to i32[8, 128]."""
    s = int(v[:BLK, 0].to(torch.int64).sum())
    s = (s + 2 ** 31) % 2 ** 32 - 2 ** 31
    return torch.full((8, ROW), s, dtype=torch.int32, device=v.device)


def extract_sum(v):
    """P3: ``v`` i32[rows >= 64, 128] -> i32[8, 128]: ``extract_sum_kernel``
    in one block (64 scalar loads, two warp reductions, one 16-byte store a
    thread), on CUDA; :func:`extract_sum_ref` on the CPU."""
    dev = _device_of(v, "extract_sum")
    if v.ndim != 2 or v.shape[0] < BLK:
        raise ValueError(f"v: want int32[>= {BLK}, {ROW}], got {list(v.shape)}")
    _check(dev, [("v", v, torch.int32, (v.shape[0], ROW))])
    if dev.type == "cpu":
        return extract_sum_ref(v)
    out = torch.empty((8, ROW), dtype=torch.int32, device=dev)
    _run(dev, "extract_sum", _build.load("probes3").extract_sum_launch,
         v.data_ptr(), out.data_ptr())
    extract_sum.launches += 1
    return out


extract_sum.launches = 0  # kernel launches since the last reset


def pass7_ref(planes):
    """The seven planes, copied."""
    return tuple(p.clone() for p in planes)


def pass7(planes):
    """P5: seven f32[rows, 128] planes -> their copies: one launch of
    ``pass7_kernel`` (64 rows a block) on CUDA; :func:`pass7_ref` on the
    CPU."""
    if len(planes) != 7:
        raise ValueError(f"pass7 takes 7 planes, got {len(planes)}")
    dev = _device_of(planes[0], "pass7")
    rows = planes[0].shape[0]
    _check(dev, [(f"planes[{k}]", p, torch.float32, (rows, ROW))
                 for k, p in enumerate(planes)])
    if dev.type == "cpu":
        return pass7_ref(planes)
    outs = tuple(torch.empty_like(p) for p in planes)
    _run(dev, "pass7", _build.load("probes3").pass7_launch,
         *(p.data_ptr() for p in planes), *(o.data_ptr() for o in outs), rows)
    pass7.launches += 1
    return outs


pass7.launches = 0  # kernel launches since the last reset

KERNELS = (gather_rows_smem, gather_rows_async, extract_sum, pass7)


def cuda_ms(fn, n=20, windows=5):
    """Milliseconds a call of ``fn`` on the card: CUDA events around ``n``
    back-to-back calls after a warm-up, median of ``windows``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def probe_inputs(device="cuda", seed=0):
    """The probe script's inputs, made with NumPy from ``seed``: the
    [4096, 128] arange table, [254, 16] ids, P4's zero volume and its
    [32512, 128] indices, P5's seven zero planes."""
    rng = np.random.default_rng(seed)
    tab = torch.arange(NROWS * ROW, dtype=torch.int32).reshape(NROWS, ROW)
    ids = torch.from_numpy(rng.integers(0, NROWS, (NB, IDS)).astype(np.int32))
    vol = torch.zeros(256 ** 3, dtype=torch.uint8)
    idxs = torch.from_numpy(rng.integers(0, 256 ** 3, (T, ROW)).astype(np.int32))
    planes = tuple(torch.zeros((T, ROW)) for _ in range(7))
    return dict(tab=tab.to(device), ids=ids.to(device), vol=vol.to(device),
                idxs=idxs.to(device), planes=tuple(p.to(device) for p in planes))


def main():
    """Run the five probes on the card at the script's shapes; print one
    line a probe (ms a call, and whether the kernel equals its plain
    version) and return the times by name."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA card")
    x = probe_inputs()
    tab, ids = x["tab"], x["ids"]
    vol, idxs = x["vol"], x["idxs"].long()
    want = gather_rows_ref(ids, tab)
    probes = [
        ("P1 smem-scalar 16-row copies x254blk",
         lambda: gather_rows_smem(ids, tab), want),
        ("P2 TMA bulk, 16 rows in flight x254blk",
         lambda: gather_rows_async(ids, tab), want),
        ("P2 TMA bulk, each row waited x254blk",
         lambda: gather_rows_async(ids, tab, pipelined=False), want),
        ("P3 64 scalar extracts, one block", lambda: extract_sum(tab[:BLK]),
         extract_sum_ref(tab[:BLK])),
        ("P4 torch u8 gather 2M (library call)",
         lambda: vol[idxs], None),
        ("P5 pass-through 7-state 508 programs", lambda: pass7(x["planes"]),
         x["planes"]),
    ]
    times = {}
    for name, fn, ref in probes:
        ok = "" if ref is None else (
            f", equals plain: {all(torch.equal(a, b) for a, b in zip(fn(), ref))}"
            if isinstance(ref, tuple) else f", equals plain: {torch.equal(fn(), ref)}")
        times[name] = cuda_ms(fn)
        print(f"{name}: {times[name]:.4f} ms{ok}", flush=True)
    return times


if __name__ == "__main__":
    main()
