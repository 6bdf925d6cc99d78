"""World tables of the PyTorch port against the JAX package's builders.

The same inputs, made from a fixed seed with NumPy, go through the JAX
host builders and their ports: noise, materials, the demo terrain, the
seven v3 bit planes and the packed v4 tables must be bit-equal (the port
holds uint32 words as int32 with the same bits).
"""

import numpy as np
import pytest
import torch

from voxelraytracing_tpu.ops import materials as j_materials
from voxelraytracing_tpu.ops import noise as j_noise
from voxelraytracing_tpu.ops import wavefront as j1
from voxelraytracing_tpu.ops import wavefront3 as j3
from voxelraytracing_tpu.ops import wavefront4 as j4
from voxelraytracing_tpu.world import demo as j_demo
from voxelraytracing_tpu_torch.convert import (
    prepared_from_numpy,
    render_grid3_from_numpy,
)
from voxelraytracing_tpu_torch.ops import materials, noise
from voxelraytracing_tpu_torch.ops import wavefront as t1
from voxelraytracing_tpu_torch.ops import wavefront3 as t3
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.world import demo
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

# the bit planes, and the v1 brick tables of the "gather" hit-id route
PLANES = ("gw_jump", "gw_liq", "wmeta", "sw_meta", "sw_solid", "sw_liq",
          "sw_pid", "brick_dir", "bricks")


def u32(t):
    return t.cpu().numpy().view(np.uint32)


@pytest.fixture(scope="module")
def demo_world():
    """The 4-chunk demo world through both host builders."""
    w = 4
    perm = noise.make_permutation(7)
    grids, cells = demo.demo_chunk_grids_host(
        perm, np.zeros(3, np.int64), w, w * 32 * 0.45, int(w * 32 * 0.28))
    wmin = np.array([32, -64, 0], np.int32)
    jrg = j3.build_render_grid3_host(grids, cells, wmin, w,
                                     j_demo.demo_materials())
    trg = t3.build_render_grid3_host(grids, cells, wmin, w,
                                     demo.demo_materials(), device="cpu")
    return jrg, trg


@pytest.fixture(scope="module")
def noise_world():
    """A random-noise 2-chunk grid: 23 voxel ids (3 of them liquid), so
    subwindows overflow the 16-entry palette; an air slab and a water slab
    make jumpable and all-liquid bricks, and one chunk slot is unused."""
    rng = np.random.default_rng(20261016)
    w = 2
    styles = {
        i: {"color": tuple(float(c) for c in rng.random(3)),
            "state": "liquid" if i in (3, 7, 11) else "solid"}
        for i in range(1, 24)
    }
    grids = rng.integers(0, 24, size=(w ** 3, 32, 32, 32)).astype(np.int32)
    grids[:, :, 24:, :] = 0
    grids[:, :, 16:24, :] = 7
    grids[:, 5:9, 10:14, 3:30] = 3
    cells = np.arange(w ** 3, dtype=np.int32)
    cells[5] = -1
    jrg = j3.build_render_grid3_host(
        grids, cells, np.zeros(3, np.int32), w,
        j_materials.make_material_table(40, styles))
    trg = t3.build_render_grid3_host(
        grids, cells, np.zeros(3, np.int32), w,
        materials.make_material_table(40, styles), device="cpu")
    return jrg, trg


@pytest.mark.parametrize("seed", [0, 7, -3, 2**40 + 5, -(2**62)])
def test_permutation_and_seed_chain(seed):
    np.testing.assert_array_equal(noise.make_permutation(seed),
                                  j_noise.make_permutation(seed))
    assert noise.transmute_seed(seed) == j_noise.transmute_seed(seed)


def test_perlin_samples_equal():
    rng = np.random.default_rng(5)
    perm = noise.make_permutation(11)
    pos = (rng.standard_normal((400, 2)) * 300).astype(np.float32)
    a, b = noise.sample01_np(perm, pos), j_noise.sample01_np(perm, pos)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    np.testing.assert_array_equal(noise.perlin2d_np(perm, pos),
                                  j_noise.perlin2d_np(perm, pos))


def test_demo_grids_equal():
    perm = noise.make_permutation(3)
    args = (perm, np.array([1, -1, 2]), 2, 2 * 32 * 0.45, int(2 * 32 * 0.28))
    g, c = demo.demo_chunk_grids_host(*args)
    jg, jc = j_demo.demo_chunk_grids_host(*args)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(c, jc)
    assert demo.DEMO_STYLES == j_demo.DEMO_STYLES


def test_materials_maps_and_lut_equal():
    rng = np.random.default_rng(9)
    styles = {int(i): {"color": tuple(float(c) for c in rng.random(3)),
                       "state": ("solid", "liquid", "gas")[i % 3],
                       "scatter": float(rng.random()), "emission": 0.5}
              for i in rng.choice(np.arange(1, 300), 40, replace=False)}
    t, j = (materials.make_material_table(256, styles),
            j_materials.make_material_table(256, styles))
    for f in t._fields:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    for a, b in zip(t1.render_id_maps(t.is_liquid),
                    j1.render_id_maps(j.is_liquid)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t3.color_lut_rows(t.color).numpy(),
                                  np.asarray(j3.color_lut_rows(j.color)))


@pytest.mark.parametrize("world", ["demo_world", "noise_world"])
def test_planes_equal(world, request):
    jrg, trg = request.getfixturevalue(world)
    for f in PLANES:
        a, b = np.asarray(getattr(jrg, f)), getattr(trg, f)
        assert b.dtype == torch.int32, f
        assert a.shape == tuple(b.shape), f
        # the same bits in JAX's dtype (uint32 planes, int32 brick_dir)
        np.testing.assert_array_equal(a, b.cpu().numpy().view(a.dtype), f)
    np.testing.assert_array_equal(np.asarray(jrg.world_min),
                                  trg.world_min.numpy())
    np.testing.assert_array_equal(np.asarray(jrg.to_pack), trg.to_pack.numpy())
    assert int(jrg.n_liquid) == trg.n_liquid
    assert jrg.size_voxels == trg.size_voxels
    assert jrg.palettes_ok == trg.palettes_ok == (world == "demo_world")


@pytest.mark.parametrize("world", ["demo_world", "noise_world"])
def test_prepare_grid4_bit_equal(world, request):
    jrg, trg = request.getfixturevalue(world)
    jp, tp = j4.prepare_grid4(jrg), t4.prepare_grid4(trg)
    np.testing.assert_array_equal(np.asarray(jp.sw_cont), u32(tp.sw_cont))
    np.testing.assert_array_equal(np.asarray(jp.wmeta_pad), u32(tp.wmeta_pad))


def test_interleave_words_with_bit31():
    """Words with bit 31 set: the port's int32 ``>>`` sign-extends, so a
    missing mask would show here."""
    rng = np.random.default_rng(3)
    gj = rng.integers(0, 2**32, (1, 128), dtype=np.uint64).astype(np.uint32)
    gl = rng.integers(0, 2**32, (1, 128), dtype=np.uint64).astype(np.uint32)
    gj[0, :8] |= np.uint32(0x80000000)
    meta = rng.integers(0, 2**32, (50, 8), dtype=np.uint64).astype(np.uint32)
    meta[:, :4] |= np.uint32(0x80008000)
    as_t = [torch.from_numpy(x.view(np.int32)) for x in (gj, gl, meta)]
    np.testing.assert_array_equal(
        u32(t4._interleave_gw(as_t[0], as_t[1])),
        np.asarray(j4._interleave_gw(gj, gl)))
    np.testing.assert_array_equal(
        u32(t4._interleave_meta(as_t[2])),
        np.asarray(j4._interleave_meta(meta)))


@pytest.mark.parametrize("nw", [1, 3, 16, 17, 20, 33, 64])
def test_super_cell_planes_equal(nw):
    assert t3._gs_for(nw) == j3._gs_for(nw)
    rng = np.random.default_rng(nw)
    jump = rng.random(nw ** 3) < 0.8
    liq = jump & (rng.random(nw ** 3) < 0.5)
    for a, b in zip(t3._super_gplanes_np(jump, liq, nw),
                    j3._super_gplanes_np(jump, liq, nw)):
        np.testing.assert_array_equal(a, b)


def test_convert_carries_the_jax_world(demo_world):
    jrg, trg = demo_world
    rg = render_grid3_from_numpy(
        *[np.asarray(getattr(jrg, f)) for f in t3.RenderGrid3._fields],
        device="cpu")
    for f in PLANES + ("world_min", "to_pack"):
        assert torch.equal(getattr(rg, f), getattr(trg, f)), f
    assert (rg.n_liquid, rg.size_voxels, rg.palettes_ok) == (
        trg.n_liquid, trg.size_voxels, True)
    jp = j4.prepare_grid4(jrg)
    tp = prepared_from_numpy(np.asarray(jp.sw_cont), np.asarray(jp.wmeta_pad),
                             device="cpu")
    ref = t4.prepare_grid4(trg)
    assert torch.equal(tp.sw_cont, ref.sw_cont)
    assert torch.equal(tp.wmeta_pad, ref.wmeta_pad)
