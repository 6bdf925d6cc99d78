"""The port's host core against the JAX package's.

The port keeps its own copies of the JAX package's jax-free host modules
(``core/nodes``, ``coords``, ``math``, ``svo``, ``utils/log``,
``resources``) and builds its own copy of ``native/svo_core.cpp``. These
tests feed both packages the same seeded inputs (the patterns of
tests/test_core_svo.py, test_native.py and test_resources.py): node
arrays, allocator state, dense grids, parsed packs and geometry must be
equal; the native library must equal the port's spec and NumPy twins.
"""

import dataclasses
import threading
from pathlib import Path

import numpy as np
import pytest

from voxelraytracing_tpu.core import coords as j_coords
from voxelraytracing_tpu.core import math as j_math
from voxelraytracing_tpu.core import nodes as j_nodes
from voxelraytracing_tpu.core import svo as j_svo
from voxelraytracing_tpu.resources import packs as j_packs
from voxelraytracing_tpu.resources import ron as j_ron
from voxelraytracing_tpu_torch.core import coords, native, nodes, svo
from voxelraytracing_tpu_torch.core import math as t_math
from voxelraytracing_tpu_torch.core.constants import NODES_PER_CHUNK
from voxelraytracing_tpu_torch.ops import wavefront3 as t3
from voxelraytracing_tpu_torch.resources import packs, ron
from voxelraytracing_tpu_torch.utils.log import get_logger
from voxelraytracing_tpu_torch.world import render_grid as t_rg

N = 8192


def _edits(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 32, 3).astype(np.float32), int(rng.integers(0, 6)))
            for _ in range(n)]


def _terrain_grids(seed, b):
    """Merge-friendly grids: random fills can exceed the 15-bit child
    pointer (tests/test_native.py:84-92)."""
    rng = np.random.default_rng(seed)
    h = rng.integers(4, 28, (b, 32, 32))
    y = np.arange(32)[None, None, :, None]
    grids = np.where(y < h[:, :, None, :], 1, 0)
    grids[:, 10:20, 10:20, 10:20] = rng.integers(0, 4, (b, 10, 10, 10))
    return grids.astype(np.uint16)


@pytest.fixture(scope="module")
def lib():
    assert native.available(), "the port's native library did not build"
    return native


def test_svo_edits_equal_jax_spec():
    """set_node sequences (splits, writes, merges that free slots) leave
    the port's node array and allocator word for word as JAX's; the
    node-format helpers agree on arrays."""
    jn, tn = np.zeros(N, np.int32), np.zeros(N, np.int32)
    ja, ta = j_svo.NodeAlloc.new((0, 1), (1, N)), svo.NodeAlloc.new((0, 1), (1, N))
    js, ts = j_svo.Svo(0, 32), svo.Svo(0, 32)
    for i, (pos, vox) in enumerate(_edits(3, 400)):
        depth = 5 if i % 7 else 3  # some writes at a coarser depth
        js.set_node(jn, pos, vox, depth, ja)
        ts.set_node(tn, pos, vox, depth, ta)
        np.testing.assert_array_equal(tn, jn)
    assert (ta.free_mem, ta.last_used_addr, ta.total_free_mem()) == (
        ja.free_mem, ja.last_used_addr, ja.total_free_mem())
    found = [ts.find_node(tn, p) for p, _ in _edits(4, 50)]
    want = [js.find_node(jn, p) for p, _ in _edits(4, 50)]
    assert [(f.idx, f.depth, f.size) for f in found] == [
        (f.idx, f.depth, f.size) for f in want]
    arr = tn[:64]
    for fn in ("is_split", "voxel_of", "child_idx_of", "leaf", "split"):
        np.testing.assert_array_equal(getattr(nodes, fn)(arr),
                                      getattr(j_nodes, fn)(arr))
    with pytest.raises(svo.OutOfMemory):
        small = np.zeros(16, np.int32)
        alloc = svo.NodeAlloc.new((0, 1), (1, 9))
        for pos, vox in _edits(5, 20):
            svo.Svo(0, 32).set_node(small, pos, vox or 1, 5, alloc)


def test_svo_to_dense_and_host_builder_equal_jax():
    """svo_to_dense of an edited chunk and dense_to_svo_host of a sparse
    grid equal JAX's spec."""
    tn = np.zeros(N, np.int32)
    ta = svo.NodeAlloc.new((0, 1), (1, N))
    for pos, vox in _edits(6, 300):
        svo.Svo(0, 32).set_node(tn, pos, vox, 5, ta)
    np.testing.assert_array_equal(svo.svo_to_dense(tn),
                                  j_svo.svo_to_dense(tn))
    rng = np.random.default_rng(7)
    grid = ((rng.random((32, 32, 32)) < 0.01)
            * rng.integers(1, 5, (32, 32, 32))).astype(np.int32)
    got, n = svo.dense_to_svo_host(grid)
    want, wn = j_svo.dense_to_svo_host(grid)
    assert n == wn
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(svo.svo_to_dense(got), grid)


def test_coords_equal_jax():
    pos = np.random.default_rng(8).integers(-5000, 5000, (64, 3))
    for fn in ("voxel_to_chunk", "chunk_to_region"):
        for got, want in zip(getattr(coords, fn)(pos),
                             getattr(j_coords, fn)(pos)):
            np.testing.assert_array_equal(got, want)
    for fn in ("chunk_min_voxel", "chunk_max_voxel"):
        np.testing.assert_array_equal(getattr(coords, fn)(pos),
                                      getattr(j_coords, fn)(pos))
    np.testing.assert_array_equal(coords.local_to_global(pos % 32, pos),
                                  j_coords.local_to_global(pos % 32, pos))
    np.testing.assert_array_equal(
        coords.region_chunk_to_global(pos % 16, pos),
        j_coords.region_chunk_to_global(pos % 16, pos))


def test_math_equal_jax():
    """cast_ray, walk_line, the Aabb clips and the random directions on
    one seeded Generator equal JAX's."""
    rng = np.random.default_rng(9)
    solid = {tuple(p) for p in rng.integers(0, 12, (300, 3))}

    def collides(p):
        return tuple(int(v) for v in p) in solid

    for _ in range(40):
        start = rng.random(3).astype(np.float32) * 12
        rot = rng.random(2) * 6.28
        d = j_math.axis_rot_to_ray(rot)
        np.testing.assert_array_equal(t_math.axis_rot_to_ray(rot), d)
        got = t_math.cast_ray(start, d, 20.0, collides)
        want = j_math.cast_ray(start, d, 20.0, collides)
        assert (got is None) == (want is None)
        if got is not None:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        a, b = rng.integers(-20, 20, 3), rng.integers(-20, 20, 3)
        assert [tuple(p) for p in t_math.walk_line(a, b)] == [
            tuple(p) for p in j_math.walk_line(a, b)]
    for _ in range(40):
        lo = rng.random(3) * 4
        box, jbox = t_math.Aabb(lo, lo + 1), j_math.Aabb(lo, lo + 1)
        clo = rng.random(3) * 4
        c, jc = t_math.Aabb(clo, clo + 0.8), j_math.Aabb(clo, clo + 0.8)
        mv = rng.normal(size=3).astype(np.float32)
        for axis in "xyz":
            fn = f"clip_{axis}_collide"
            for m in mv:
                assert getattr(box, fn)(c, float(m)) == getattr(jbox, fn)(jc, float(m))
        assert box.intersects(c) == jbox.intersects(jc)
        g, w = box.expand(mv).grow(0.1).translate(mv), jbox.expand(mv).grow(0.1).translate(mv)
        np.testing.assert_array_equal(g.from_, w.from_)
        np.testing.assert_array_equal(g.to, w.to)
    tr, jr = np.random.default_rng(10), np.random.default_rng(10)
    for _ in range(50):
        np.testing.assert_array_equal(t_math.rand_cardinal_dir(tr),
                                      j_math.rand_cardinal_dir(jr))
        np.testing.assert_array_equal(t_math.rand_dir(tr), j_math.rand_dir(jr))
        n = (0.0, 1.0, 0.0)
        np.testing.assert_array_equal(t_math.rand_hem_dir(tr, n),
                                      j_math.rand_hem_dir(jr, n))


def test_native_set_node_and_get_voxel_equal_spec(lib):
    """The native edits equal the port's spec step by step (node arrays,
    allocator state); get_voxel and svo_to_dense read them back."""
    py_nodes, c_nodes = np.zeros(N, np.int32), np.zeros(N, np.int32)
    py_alloc = svo.NodeAlloc.new((0, 1), (1, N))
    c_alloc = lib.NativeAlloc(1, N)
    want = {}
    for pos, vox in _edits(11, 400):
        svo.Svo(0, 32).set_node(py_nodes, pos, vox, 5, py_alloc)
        assert lib.set_node(c_nodes, c_alloc, pos, vox, 5)
        np.testing.assert_array_equal(py_nodes, c_nodes)
        want[tuple(int(v) for v in pos)] = vox
    assert py_alloc.last_used_addr == c_alloc.last_used_addr
    assert py_alloc.total_free_mem() == c_alloc.total_free_mem()
    dense = lib.svo_to_dense(c_nodes)
    np.testing.assert_array_equal(dense, svo.svo_to_dense(c_nodes))
    for pos, vox in want.items():
        assert lib.get_voxel(c_nodes, pos) == vox == dense[pos]


def test_native_dense_to_svo_equal_spec(lib):
    """dense_to_svo(_batch) round-trips through the spec's svo_to_dense,
    a uniform chunk is one leaf, and a chunk past the 15-bit child
    pointer is refused."""
    grids = _terrain_grids(12, 3)
    out, counts = lib.dense_to_svo_batch(grids)
    assert out.shape == (3, NODES_PER_CHUNK)
    for i in range(3):
        one, n = lib.dense_to_svo(grids[i])
        assert n == counts[i]
        np.testing.assert_array_equal(one, out[i, :n])
        np.testing.assert_array_equal(svo.svo_to_dense(out[i]), grids[i])
        assert not out[i, n:].any()
    nodes_, n = lib.dense_to_svo(np.full((32, 32, 32), 7, np.uint16))
    assert n == 1 and nodes_[0] == nodes.leaf(7)
    checker = (np.indices((32, 32, 32)).sum(0) % 2).astype(np.uint16)
    with pytest.raises(MemoryError):
        lib.dense_to_svo(checker)


def test_native_rows_equal_numpy_twins(lib):
    """hist256_u8 equals the bincount twin, and sw_rows_build equals
    chunk_batch_sw_data bit for bit, palette overflow included
    (tests/test_native.py:106-139)."""
    rng = np.random.default_rng(13)
    ids = rng.integers(0, 256, (40, 4096)).astype(np.uint8)
    flat = (np.arange(40)[:, None] * 256 + ids.astype(np.int64)).ravel()
    np.testing.assert_array_equal(
        lib.hist256_u8(ids), np.bincount(flat, minlength=40 * 256).reshape(40, 256))
    to_pack = np.arange(256, dtype=np.int32) % 251
    calls = lib.sw_rows_build.calls
    for g in (rng.integers(0, 12, (3, 32, 32, 32)),    # <= 16 solid ids
              rng.integers(0, 200, (2, 32, 32, 32))):  # palette overflow
        g = g.astype(np.uint8)
        got = lib.sw_rows_build(t_rg.chunk_sw_rows(g), 3, to_pack)
        ref = t_rg.chunk_batch_sw_data(g, 3, to_pack)
        assert got["palettes_ok"] == ref["palettes_ok"]
        for k in ("sw_solid", "sw_liq", "sw_meta", "sw_pid", "any_solid",
                  "all_liq", "any_liq"):
            np.testing.assert_array_equal(got[k], ref[k], k)
    assert lib.sw_rows_build.calls == calls + 2
    assert not ref["palettes_ok"]


def test_builders_take_the_native_paths(lib, monkeypatch):
    """The streaming builder's rows come from sw_rows_build and the
    palette histogram from hist256_u8 while the library is available, and
    their tables equal the NumPy twins' (native.available() forced
    False)."""
    from voxelraytracing_tpu_torch.world.demo import (
        demo_chunk_grids_host, demo_materials)
    from voxelraytracing_tpu_torch.ops import noise

    grids, _ = demo_chunk_grids_host(noise.make_permutation(7),
                                     np.zeros(3, np.int64), 2, 28.8, 17)
    cells = [(i % 2, i // 2 % 2, i // 4) for i in range(8)]
    mats = demo_materials()
    calls = lib.sw_rows_build.calls
    b = t_rg.RenderGrid3Builder(2, mats, device="cpu")
    b.set_chunks(cells, grids)
    assert lib.sw_rows_build.calls == calls + 1
    hists = []
    monkeypatch.setattr(lib, "hist256_u8",
                        lambda ids, f=lib.hist256_u8: hists.append(1) or f(ids))
    rg_native = t3.build_render_grid3_host(grids, np.arange(8), np.zeros(3),
                                           2, mats, device="cpu")
    assert hists
    monkeypatch.setattr(lib, "available", lambda: False)
    twin = t_rg.RenderGrid3Builder(2, mats, device="cpu")
    twin.set_chunks(cells, grids)
    assert lib.sw_rows_build.calls == calls + 1
    for k in ("sw_solid", "sw_liq", "sw_meta", "sw_pid", "wmeta"):
        np.testing.assert_array_equal(getattr(b, k), getattr(twin, k), k)
    rg_twin = t3.build_render_grid3_host(grids, np.arange(8), np.zeros(3),
                                         2, mats, device="cpu")
    for f, x, y in zip(rg_twin._fields, rg_native, rg_twin):
        if hasattr(x, "shape"):
            assert (x == y).all(), f


def test_native_build_is_atomic_under_a_lock(tmp_path, monkeypatch):
    """Four threads that build the library into an empty directory at
    once run g++ once between them, each gets the complete library, and
    no temporary file is left; the build lies outside the JAX package's
    ``native/``."""
    root = Path(__file__).resolve().parents[1]
    assert native.library_path().parent == root / "build" / "native"
    assert native.SOURCE == root / "voxelraytracing_tpu_torch" / "native" / "svo_core.cpp"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    runs = []
    real_run = native.subprocess.run
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **k: runs.append(a) or real_run(*a, **k))
    out = [None] * 4
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, native.build()))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(runs) == 1 and len(set(out)) == 1 and out[0].is_file()
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) == sorted(
        [out[0].name, "lock"])


def _plain(x):
    """A pack as nested plain values, class names kept."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, (j_packs.VoxelPack, packs.VoxelPack)):
        return ("VoxelPack", [_plain(v) for v in x])
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [_plain(v) for v in x])
    return x


def test_resources_equal_jax():
    """The builtin respack parses field by field as JAX's, and the
    stylepack's material table is JAX's."""
    got = packs.Resources.load_from(packs.builtin_respack_path())
    want = j_packs.Resources.load_from(j_packs.builtin_respack_path())
    assert packs.builtin_respack_path() == j_packs.builtin_respack_path()
    assert _plain(got) == _plain(want)
    dp, sp = got.datapacks["terra"], got.stylepacks["terra"]
    jdp, jsp = want.datapacks["terra"], want.stylepacks["terra"]
    for n_voxels in (None, 300):
        m = sp.material_table(dp.voxels, n_voxels)
        jm = jsp.material_table(jdp.voxels, n_voxels)
        for f in m._fields:
            np.testing.assert_array_equal(getattr(m, f), getattr(jm, f), f)


BAD = [
    ("ron", "[1, 2"), ("ron", "1 2"), ("ron", '"open'), ("ron", "(a: 1,"),
    ("ron", "{1: }"), ("voxels", '[VoxelData(name: "a"), VoxelData(name: "a")]'),
    ("voxels", '[Foo(name: "a")]'),
    ("styles", '[("a", VoxelStyle()), ("a", VoxelStyle())]'),
]


@pytest.mark.parametrize("kind,src", BAD)
def test_errors_raise_jax_classes(kind, src):
    """Malformed RON and invalid packs raise the exception classes JAX's
    parser raises."""
    def outcome(mod_ron, mod_packs):
        fn = {"ron": mod_ron.loads, "voxels": mod_packs.parse_voxelpack,
              "styles": mod_packs.parse_voxel_stylepack}[kind]
        try:
            fn(src)
        except Exception as e:  # noqa: BLE001 (the class is the result)
            return type(e).__name__, [c.__name__ for c in type(e).__mro__]
        return None

    got, want = outcome(ron, packs), outcome(j_ron, j_packs)
    assert want is not None and got == want
    assert issubclass(ron.RonError, ValueError)


def test_logger_lives_under_the_port(monkeypatch):
    """The port's loggers live under its package; the handler, level and
    propagation that ``get_logger`` sets up are restored afterwards, so a
    later test of this process still reads records through ``caplog``."""
    import logging

    from voxelraytracing_tpu_torch.utils import log as port_log

    root = logging.getLogger("voxelraytracing_tpu_torch")
    saved = (list(root.handlers), root.propagate, root.level)
    monkeypatch.setattr(port_log, "_initialized", port_log._initialized)
    try:
        assert get_logger("x").name == "voxelraytracing_tpu_torch.x"
        assert get_logger("voxelraytracing_tpu_torch.y").name == (
            "voxelraytracing_tpu_torch.y")
    finally:
        root.handlers[:] = saved[0]
        root.propagate = saved[1]
        root.setLevel(saved[2])
