"""The port's streaming world builder against the JAX package's.

The same chunks, made from a fixed seed with NumPy, go through the JAX
``RenderGrid3Builder`` and its port, step by step through install, edit
and eviction; after every step the raw planes (``grid()``), the dense
packed tables (``prepared()``) and the sparse tables (``sw_cont``,
``wmeta_pad``, the subwindow -> row map, the free list, the footprint)
must be equal word for word. The port holds uint32 words as int32 with the
same bits. The JAX builder may take its native row builder here; the port
runs the NumPy twin, which must give the same rows.
"""

import numpy as np
import pytest

from voxelraytracing_tpu.ops import materials as j_materials
from voxelraytracing_tpu.ops import noise as j_noise
from voxelraytracing_tpu.ops.wavefront import render_id_maps
from voxelraytracing_tpu.ops.wavefront4 import prepare_grid4 as j_prepare_grid4
from voxelraytracing_tpu.world import demo as j_demo
from voxelraytracing_tpu.world import render_grid as jr
from voxelraytracing_tpu_torch.convert import prepared_sparse_from_numpy
from voxelraytracing_tpu_torch.ops import materials
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.world import demo
from voxelraytracing_tpu_torch.world import render_grid as tr
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

PLANES = ("gw_jump", "gw_liq", "wmeta", "sw_meta", "sw_solid", "sw_liq",
          "sw_pid")


def u32(t):
    return t.cpu().numpy().view(np.uint32)


def _demo_chunks(w):
    grids, cells = j_demo.demo_chunk_grids_host(
        j_noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    cell_xyz = [(int(c % w), int((c // w) % w), int(c // (w * w)))
                for c in cells]
    return grids, cell_xyz


def _noise_chunks():
    """The palette-overflow noise chunks of tests/test_torch_palettes.py
    and their material tables in both packages."""
    rng = np.random.default_rng(20261016)
    styles = {
        i: {"color": tuple(float(c) for c in rng.random(3)),
            "state": "liquid" if i in (3, 7, 11) else "solid"}
        for i in range(1, 24)
    }
    grids = rng.integers(0, 24, size=(8, 32, 32, 32)).astype(np.int32)
    grids[:, :, 24:, :] = 0
    grids[:, :, 16:24, :] = 7
    grids[:, 5:9, 10:14, 3:30] = 3
    return (grids, j_materials.make_material_table(40, styles),
            materials.make_material_table(40, styles))


@pytest.mark.parametrize("chunks", ["demo", "noise"])
def test_chunk_batch_sw_data_matches_jax(chunks):
    if chunks == "demo":
        grids = _demo_chunks(2)[0]
        mats = j_demo.demo_materials()
    else:
        grids, mats, _ = _noise_chunks()
    to_render, to_pack, n_liq = render_id_maps(np.asarray(mats.is_liquid))
    rg = to_render[grids.astype(np.int64)]
    a = tr.chunk_batch_sw_data(rg, n_liq, to_pack)
    b = jr.chunk_batch_sw_data(rg, n_liq, to_pack)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), k)
    assert a["palettes_ok"] == (chunks == "demo")


def _steps(grids, cell_xyz):
    """Install, edit and eviction, as tests/test_engine_app.py:134-169 and
    :332-370 drive the builder: (name, call on a builder)."""
    edited = np.array(grids[:1])
    edited[0, :, 16:, :] = 0
    return [
        ("install", lambda b: b.set_chunks(cell_xyz, grids)),
        ("edit", lambda b: b.set_chunks(cell_xyz[:1], edited)),
        ("evict one", lambda b: b.clear_cells(cell_xyz[1:2])),
        ("evict all", lambda b: b.clear_cells(cell_xyz)),
        ("reinstall one", lambda b: b.set_chunks(cell_xyz[:1], grids[:1])),
    ]


def _assert_grids_equal(got, ref, name):
    for f in PLANES:
        np.testing.assert_array_equal(u32(getattr(got, f)),
                                      np.asarray(getattr(ref, f)),
                                      f"{name}: {f}")
    np.testing.assert_array_equal(got.world_min.numpy(),
                                  np.asarray(ref.world_min))
    np.testing.assert_array_equal(got.to_pack.numpy(), np.asarray(ref.to_pack))
    assert (got.n_liquid, got.size_voxels, got.palettes_ok) == (
        int(ref.n_liquid), ref.size_voxels, ref.palettes_ok)


def test_dense_builder_matches_jax():
    """W=2, dense: grid() planes and the incrementally kept prepared()
    tables equal JAX's after every step, and equal the port's one-shot
    prepare_grid4 of the same grid; grid() is identity-stable."""
    grids, cell_xyz = _demo_chunks(2)
    jb = jr.RenderGrid3Builder(2, j_demo.demo_materials(),
                               world_min=(32, -64, 0))
    tb = tr.RenderGrid3Builder(2, demo.demo_materials(),
                               world_min=(32, -64, 0), device="cpu")
    assert not tb.sparse and (tb.ns, tb.nw) == (jb.ns, jb.nw)
    for name, step in _steps(grids, cell_xyz):
        step(jb)
        step(tb)
        got = tb.grid()
        assert tb.grid() is got
        _assert_grids_equal(got, jb.grid(), name)
        tp, jp = tb.prepared(), jb.prepared()
        for f in ("sw_cont", "wmeta_pad"):
            np.testing.assert_array_equal(u32(getattr(tp, f)),
                                          np.asarray(getattr(jp, f)),
                                          f"{name}: {f}")
            np.testing.assert_array_equal(
                u32(getattr(tp, f)),
                np.asarray(getattr(j_prepare_grid4(jb.grid()), f)))
            np.testing.assert_array_equal(
                u32(getattr(tp, f)), u32(getattr(t4.prepare_grid4(got), f)))


def _assert_sparse_equal(tb, jb, name):
    tp, jp = tb.prepared(), jb.prepared()
    assert isinstance(tp, t4.PreparedGrid4Sparse) and tp.ns == jp.ns
    np.testing.assert_array_equal(u32(tp.sw_cont), np.asarray(jp.sw_cont),
                                  f"{name}: sw_cont")
    np.testing.assert_array_equal(u32(tp.wmeta_pad), np.asarray(jp.wmeta_pad),
                                  f"{name}: wmeta_pad")
    np.testing.assert_array_equal(tb._sp_row, jb._sp_row)
    np.testing.assert_array_equal(tb._sp_own, jb._sp_own)
    assert tb._sp_free == jb._sp_free and tb._sp_next == jb._sp_next
    assert tb._sp_canon == jb._sp_canon
    assert tb.sparse_tables_mb() == jb.sparse_tables_mb()
    return tp


def _assert_sparse_consistent(tp, tb):
    """Each window row's lanes 64-127 name a row whose meta lane 8 holds
    that subwindow's id, or the canonical stamp, and whose subwindow the
    window meta does not jump; a -1 lane is an empty subwindow (a jump by
    the builder's own flags)."""
    ns, nw = tp.ns, round(tp.wmeta_pad.shape[0] ** (1 / 3))
    empty = ~tb.s_any_solid & (tb.s_all_liq | ~tb.s_any_liq)
    wm = u32(tp.wmeta_pad)[:, 0]
    swc = u32(tp.sw_cont)
    l = np.arange(64)
    for w in range(nw ** 3):
        wx, wy, wz = w % nw, (w // nw) % nw, w // (nw * nw)
        sids = ((wx * 4 + (l & 3)) + (wy * 4 + ((l >> 2) & 3)) * ns
                + (wz * 4 + (l >> 4)) * ns * ns)
        rows = wm[w, 64:].astype(np.int64)
        has = rows != 0xFFFFFFFF
        stamp = swc[rows[has], 6, 8]
        assert ((stamp == sids[has]) | (stamp == tr._CANON_STAMP)).all()
        jump = (wm[w, (l >> 4)] >> ((l & 15) * 2)) & 1
        np.testing.assert_array_equal(jump[has], 0)
        assert empty[sids[~has]].all()
        assert not wm[w, 8:64].any()


def test_sparse_builder_matches_jax():
    """W=4 with sparse=True: first an empty world (the 16-row table),
    then install (growth to 4096 rows and a full re-upload), edit and
    eviction; the tables, the row map, the free list and the footprint
    equal JAX's after every step, and the tables are consistent."""
    grids, cell_xyz = _demo_chunks(4)
    jb = jr.RenderGrid3Builder(4, j_demo.demo_materials(), sparse=True)
    tb = tr.RenderGrid3Builder(4, demo.demo_materials(), sparse=True,
                               device="cpu")
    _assert_sparse_equal(tb, jb, "empty")
    assert tb._sp_cap == 16
    for name, step in _steps(grids, cell_xyz):
        step(jb)
        step(tb)
        _assert_grids_equal(tb.grid(), jb.grid(), name)
        tp = _assert_sparse_equal(tb, jb, name)
        _assert_sparse_consistent(tp, tb)
        if name == "install":
            assert tb._sp_cap == 4096 and tb._sp_next > 16
            assert (tb._sp_row >= 0).sum() > tb._sp_next  # shared rows
    assert tb.sparse_tables_mb() < 50.0
    # the JAX token carried across is the builder's token
    jp = jb.prepared()
    cp = prepared_sparse_from_numpy(np.asarray(jp.sw_cont),
                                    np.asarray(jp.wmeta_pad), jp.ns,
                                    device="cpu")
    tp = tb.prepared()
    assert cp.ns == tp.ns and bool((cp.sw_cont == tp.sw_cont).all())
    assert bool((cp.wmeta_pad == tp.wmeta_pad).all())


def test_sparse_switch():
    """Sparse tables by themselves only past 64 chunks (JAX
    render_grid.py:230); callers ask for them earlier."""
    mats = demo.demo_materials()
    for w, want in ((2, False), (64, False), (65, True)):
        assert tr.RenderGrid3Builder(w, mats, device="cpu").sparse == want
    assert tr.RenderGrid3Builder(2, mats, sparse=True, device="cpu").sparse
