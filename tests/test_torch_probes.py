"""The port's primitive probes (``voxelraytracing_tpu_torch.experiments``)
against the TPU probe kernels of ``experiments/v3_probe_prims.py`` and
``experiments/v3_probe_subgather.py``, on the CPU.

The probe scripts run TPU-only calls and timings at module level, so they
are neither imported nor run: their kernel bodies and their
``pl.pallas_call`` expressions are taken out of the files with ``ast`` and
evaluated with small sizes (NB=8, T=256, a grid of 2) and
``interpret=True``. Every plain version equals its JAX kernel exactly.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from voxelraytracing_tpu_torch.experiments import v3_probe_prims as pp
from voxelraytracing_tpu_torch.experiments import v3_probe_subgather as ps

from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
SMALL = dict(BLK=64, NROWS=4096, NB=8, T=256)


def _probe(fname):
    """The kernels (``k_*``, and the spec helper ``vs``) of a probe script,
    defined in a namespace with the small sizes, and its ``pallas_call``
    expressions by the name of their first argument."""
    tree = ast.parse((EXPERIMENTS / fname).read_text())
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, np=np, **SMALL)
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and (
                node.name.startswith("k_") or node.name == "vs"):
            exec(compile(ast.Module([node], []), fname, "exec"), ns)
    calls = {n.args[0].id: n for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr == "pallas_call"}
    return ns, calls


def _pallas(probe, call, kernel=None, grid=None):
    """The script's ``pallas_call`` in interpret mode, with ``kernel`` in
    place of its first argument and ``grid`` in place of its grid."""
    ns, calls = probe
    node = calls[call]
    kw = [k for k in node.keywords if not (grid and k.arg == "grid")]
    if grid:
        kw.append(ast.keyword("grid", ast.parse(repr(grid), mode="eval").body))
    kw.append(ast.keyword("interpret", ast.Constant(True)))
    args = [ast.Name(kernel, ast.Load())] if kernel else node.args
    expr = ast.fix_missing_locations(
        ast.Expression(ast.Call(node.func, args, kw)))
    return eval(compile(expr, "probe", "eval"), ns)


@pytest.fixture(scope="module")
def prims():
    return _probe("v3_probe_prims.py")


@pytest.fixture(scope="module")
def subgather():
    return _probe("v3_probe_subgather.py")


def _table(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2 ** 31, 2 ** 31, (SMALL["NROWS"], 128),
                        dtype=np.int64).astype(np.int32)


def _ids(seed, shape):
    return np.random.default_rng(seed + 1).integers(
        0, SMALL["NROWS"], shape).astype(np.int32)


@pytest.mark.parametrize("wrapper", ["smem", "async", "async_pipelined",
                                     "async_serial"])
def test_row_gathers_equal_k_dma(prims, wrapper):
    """P1 and P2 (by default, with all rows in flight, and with each row
    waited) compute k_dma's function: ``out[i, k] = tab[ids[i, k]]``."""
    tab, ids = _table(0), _ids(0, (SMALL["NB"], 16))
    want = np.asarray(_pallas(prims, "k_dma")(jnp.asarray(ids),
                                              jnp.asarray(tab)))
    fn = {"smem": pp.gather_rows_smem, "async": pp.gather_rows_async,
          "async_pipelined": lambda i, t: pp.gather_rows_async(
              i, t, pipelined=True),
          "async_serial": lambda i, t: pp.gather_rows_async(
              i, t, pipelined=False)}[wrapper]
    got = fn(torch.from_numpy(ids), torch.from_numpy(tab))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_k_smem_does_not_trace(prims):
    """P1's own kernel fails to trace as written (its out block's leading
    axis has size 1), so on the TPU its ``try`` printed "P1 FAIL"; the
    port computes its intended function, k_dma's."""
    tab, ids = _table(0), _ids(0, (SMALL["NB"], 16))
    with pytest.raises(Exception, match="Invalid shape"):
        _pallas(prims, "k_smem")(jnp.asarray(ids), jnp.asarray(tab))


@pytest.mark.parametrize("wraps", [False, True])
def test_extract_sum_equals_k_extract(prims, wraps):
    """P3: the int32 sum of ``v[0:64, 0]`` broadcast to (8, 128); with
    full-range values the sum wraps as JAX's does."""
    v = _table(2)[:64]
    if not wraps:
        v = v >> 8
    total = int(v[:, 0].astype(np.int64).sum())
    assert (not -2 ** 31 <= total < 2 ** 31) == wraps
    want = np.asarray(_pallas(prims, "k_extract")(jnp.asarray(v)))
    got = pp.extract_sum(torch.from_numpy(v))
    assert got.dtype == torch.int32 and got.shape == (8, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pass7_equals_k_pass(prims):
    """P5: seven planes copied through, bit for bit (NaN payloads and -0
    included)."""
    rng = np.random.default_rng(3)
    planes = [rng.integers(0, 2 ** 32, (SMALL["T"], 128), dtype=np.uint64)
              .astype(np.uint32).view(np.float32) for _ in range(7)]
    want = _pallas(prims, "k_pass")(*map(jnp.asarray, planes))
    got = pp.pass7(tuple(torch.from_numpy(p) for p in planes))
    assert len(got) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))


@pytest.mark.parametrize("seed", [4, 5])
@pytest.mark.parametrize("which", ["vec", "loop"])
def test_subgather_equals_its_kernels(subgather, which, seed):
    """``vec``: ``out[j, l] = tab[idx[j, l], l]`` (k_gather); ``loop``:
    ``out[j, :] = tab[idx[j, 0], :]`` (k_loop); grid of 2."""
    tab, idx = _table(seed), _ids(seed, (64, 128))
    kern, fn = {"vec": ("k_gather", ps.col_gather),
                "loop": ("k_loop", ps.row_loop)}[which]
    want = np.asarray(_pallas(subgather, "kern", kernel=kern, grid=(2,))(
        jnp.asarray(tab), jnp.asarray(idx)))
    got = fn(torch.from_numpy(tab), torch.from_numpy(idx))
    assert got.dtype == torch.int32 and got.shape == (64, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_calls_launch_nothing():
    """On CPU tensors the wrappers run their plain versions: no kernel
    launch is counted and nothing is built."""
    tab, ids = torch.from_numpy(_table(6)), torch.from_numpy(_ids(6, (2, 16)))
    kernels = pp.KERNELS + ps.KERNELS
    before = [k.launches for k in kernels]
    pp.gather_rows_smem(ids, tab)
    pp.gather_rows_async(ids, tab)
    pp.extract_sum(tab)
    pp.pass7(tuple(torch.zeros(64, 128) for _ in range(7)))
    idx = torch.from_numpy(_ids(6, (64, 128)))
    ps.col_gather(tab, idx)
    ps.row_loop(tab, idx)
    assert [k.launches for k in kernels] == before


def test_wrappers_reject_bad_inputs():
    """Wrong dtypes, shapes, plane counts and devices raise before any
    launch."""
    tab = torch.zeros(64, 128, dtype=torch.int32)
    ids = torch.zeros(2, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="ids"):
        pp.gather_rows_smem(ids.long(), tab)
    with pytest.raises(ValueError, match="ids"):
        pp.gather_rows_async(torch.zeros(2, 8, dtype=torch.int32), tab)
    with pytest.raises(ValueError, match="tab"):
        pp.gather_rows_smem(ids, tab[:, :64].contiguous())
    with pytest.raises(ValueError, match="v"):
        pp.extract_sum(tab[:32])
    with pytest.raises(ValueError, match="7 planes"):
        pp.pass7(tuple(torch.zeros(64, 128) for _ in range(6)))
    with pytest.raises(ValueError, match="planes"):
        pp.pass7(tuple(torch.zeros(64, 128, dtype=torch.float64)
                       for _ in range(7)))
    with pytest.raises(ValueError, match="idx"):
        ps.col_gather(tab, torch.zeros(64, 128))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ps.row_loop(tab.to("meta"), ids.to("meta"))


def test_gather_rows_async_rejects_misaligned_table():
    """The TMA kernel's bulk copies need a 16-byte aligned table: a table
    one word into a flat buffer raises on the CPU too, before the plain
    version runs; an aligned view of the same buffer does not."""
    tab, ids = _table(7), torch.from_numpy(_ids(7, (2, 16)))
    flat = torch.zeros(tab.size + 4, dtype=torch.int32)
    for off, ok in ((1, False), (4, True)):
        view = flat[off:off + tab.size].view(tab.shape)
        view.copy_(torch.from_numpy(tab))
        if ok:
            got = pp.gather_rows_async(ids, view)
            assert torch.equal(got, pp.gather_rows_ref(ids, view))
        else:
            with pytest.raises(ValueError, match="16-byte aligned"):
                pp.gather_rows_async(ids, view)
