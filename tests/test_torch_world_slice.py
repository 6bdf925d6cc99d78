"""The port's SVO world slices and v1 device builder against JAX's, word
for word: ``ChunkAlloc`` and ``NodePool`` (insert, reuse in place,
reallocate, remove), ``build_world_slice``, ``assemble_world_slice`` with
unused slots, ``make_demo_world(7, 4)`` and ``build_render_grid`` (torch)
against JAX's ``build_render_grid`` and the port's
``build_render_grid_host`` on a 4-chunk world with unused slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelraytracing_tpu.ops import wavefront as jwf
from voxelraytracing_tpu.world import assemble as jasm
from voxelraytracing_tpu.world import pool as jpool

from voxelraytracing_tpu_torch.ops import noise, wavefront
from voxelraytracing_tpu_torch.ops.svo_build import build_chunk_svo_batch
from voxelraytracing_tpu_torch.world import assemble, pool
from voxelraytracing_tpu_torch.world.demo import (
    demo_chunk_grids_host, demo_materials, make_demo_world)

from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

CPU = dict(device="cpu")


def _chunks(rng, n, sizes=(1, 9, 300, 2500)):
    return [rng.integers(0, 1 << 16, sizes[i % len(sizes)], dtype=np.int64)
            .astype(np.int32) for i in range(n)]


def test_chunk_alloc_follows_jax():
    a, j = pool.ChunkAlloc(40_000), jpool.ChunkAlloc(40_000)
    ops = [("a", 10), ("a", 5000), ("a", 7), ("f", 1, 2058), ("a", 3),
           ("f", 2059, 7048), ("a", 6000), ("a", 30_000)]
    for op in ops:
        for x in (a, j):
            if op[0] == "a":
                try:
                    got = x.alloc_chunk(op[1])
                except MemoryError as e:
                    got = str(e)
            else:
                got = x.free_chunk(op[1], op[2])
            x.last = got
        assert a.last == j.last, op
        assert a.free_mem == j.free_mem and a.status() == j.status(), op


def test_node_pool_insert_reuse_reallocate_remove():
    rng = np.random.default_rng(11)
    ours, theirs = pool.NodePool(60_000), jpool.NodePool(60_000)
    c = _chunks(rng, 6)
    seq = [("i", "a", c[0]), ("i", "b", c[3]), ("i", "a", c[1]),  # reuse
           ("i", "a", c[3][:2100]),                            # reuse, grown
           ("i", "b", np.concatenate([c[3], c[2]])),           # reallocate
           ("r", "a"), ("i", "c", c[2]), ("r", "zz"), ("i", "d", c[5])]
    for op in seq:
        for p in (ours, theirs):
            p.out = (p.insert_chunk(op[1], op[2]) if op[0] == "i"
                     else p.remove_chunk(op[1]))
        assert ours.out == theirs.out, op
        assert ours.spans == theirs.spans, op
        np.testing.assert_array_equal(ours.nodes, theirs.nodes)
        assert ours.alloc.free_mem == theirs.alloc.free_mem
    assert [ours.root_of(k) for k in "abcdz"] == [
        theirs.root_of(k) for k in "abcdz"]


def test_build_world_slice_equals_jax():
    rng = np.random.default_rng(12)
    keys = [(0, 0, 0), (1, 0, 0), (0, 1, 1), (-1, 2, 0), (5, 0, 0)]
    chunks = dict(zip(keys, _chunks(rng, len(keys))))
    for mn, w, mx in (((0, 0, 0), 2, None), ((-1, 0, 0), 3, 50_000)):
        ws, p = pool.build_world_slice(chunks, mn, w, max_nodes=mx, **CPU)
        js, jp = jpool.build_world_slice(chunks, mn, w, max_nodes=mx)
        for f in ("nodes", "chunk_roots", "world_min"):
            got = getattr(ws, f)
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(js, f)))
        assert p.spans == jp.spans
        assert ws.size_in_chunks == w and ws.size_in_voxels == 32 * w


def test_assemble_world_slice_with_unused_slots():
    rng = np.random.default_rng(13)
    w, b, stride = 3, 6, 64
    nodes = rng.integers(0, 1 << 16, (b, stride)).astype(np.int32)
    cells = np.asarray([4, -1, 26, 0, -7, 13], np.int32)
    wmin = np.asarray([-32, 64, 0], np.int32)
    ws = assemble.assemble_world_slice(nodes, cells, wmin, w, stride=stride,
                                       **CPU)
    js = jasm.assemble_world_slice(jnp.asarray(nodes), jnp.asarray(cells),
                                   jnp.asarray(wmin), w, stride=stride)
    for f in ("nodes", "chunk_roots", "world_min"):
        np.testing.assert_array_equal(getattr(ws, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert ws.chunk_roots.shape == (w ** 3,)


def test_make_demo_world_equals_jax():
    from voxelraytracing_tpu.world.demo import make_demo_world as j_make

    ws, js = make_demo_world(7, 4, **CPU), j_make(7, 4)
    for f in ("nodes", "chunk_roots", "world_min"):
        np.testing.assert_array_equal(getattr(ws, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    ws2 = make_demo_world(3, 2, min_chunk=(1, -1, 2), **CPU)
    js2 = j_make(3, 2, min_chunk=(1, -1, 2))
    for f in ("nodes", "chunk_roots", "world_min"):
        np.testing.assert_array_equal(getattr(ws2, f).numpy(),
                                      np.asarray(getattr(js2, f)), err_msg=f)


@pytest.fixture(scope="module")
def v1_world():
    w = 4
    grids, cells = demo_chunk_grids_host(
        noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    cells = cells.copy()
    cells[[5, 17, 40]] = -1  # unused slots
    return grids, cells, np.asarray([0, -32, 64], np.int32), w


def test_build_render_grid_equals_jax_and_host(v1_world):
    grids, cells, wmin, w = v1_world
    mats = demo_materials()
    rg = wavefront.build_render_grid(grids, cells, wmin, w, mats, **CPU)
    host = wavefront.build_render_grid_host(grids, cells, wmin, w, mats, **CPU)
    jrg = jwf.build_render_grid(jnp.asarray(grids), jnp.asarray(cells),
                                jnp.asarray(wmin), w, mats)
    for f in ("bwin", "lwin", "brick_dir", "bricks", "world_min", "to_pack"):
        got = getattr(rg, f)
        assert got.dtype == torch.int32, f
        assert torch.equal(got, getattr(host, f)), f
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(jrg, f)).view(np.int32), err_msg=f)
    assert rg.n_liquid == host.n_liquid == int(jrg.n_liquid)
    assert rg.size_voxels == host.size_voxels == jrg.size_voxels
    assert (rg.brick_dir < 0).any() and (rg.bwin != 0).any()


def test_svo_batch_feeds_the_slice(v1_world):
    """make_demo_world's slots: chunk i's root is 1 + i*NODES_PER_CHUNK and
    its nodes are its SVO build's row."""
    ws = make_demo_world(7, 2, **CPU)
    grids, _ = demo_chunk_grids_host(noise.make_permutation(7),
                                     np.zeros(3, np.int64), 2, 2 * 32 * 0.45,
                                     int(2 * 32 * 0.28))
    nodes, _ = build_chunk_svo_batch(grids, **CPU)
    stride = nodes.shape[1]
    assert ws.chunk_roots.tolist() == [1 + i * stride for i in range(8)]
    assert torch.equal(ws.nodes[1:].reshape(8, stride), nodes)
