"""The port's device worldgen and SVO build against the JAX package's.

Same seeds, same chunk positions, both packages (the patterns of
tests/test_worldgen.py and tests/test_core_svo.py); the port runs its
torch ops on the CPU here, as on the card. Compared exactly:

- ``build_chunk_svo(_batch)``: nodes and counts word for word, against
  JAX's builder and the port's native ``dense_to_svo_batch``;
- the noise sampler, ``WorldGen.generate_chunks`` grids and aux maps
  (``height``, ``biome``, ``peak``, ``veg_prob``) and features, and
  ``find_land_near``: against JAX evaluated under ``jax.disable_jit()``
  (its terrain pass ``_generate_impl`` one primitive at a time in NumPy,
  ``tests/jax_op_by_op.py:numpy_op_by_op``, which rounds as ``disable_jit``
  does without compiling each primitive).
  XLA's CPU compiler contracts ``a*b+c`` into FMA inside jitted programs,
  so the jitted ``TerrainGen._generate`` rounds some noise values an ulp
  apart; that path is compared by counting (``test_jitted_path_counted``);
- ``demo_chunk_grids`` on the device against its host twin and JAX's;
- ``ServerWorld``'s generate, place and rebuild steps against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelraytracing_tpu.ops import noise as j_noise
from voxelraytracing_tpu.ops.svo_build import build_chunk_svo as j_build
from voxelraytracing_tpu.ops.svo_build import build_chunk_svo_batch as j_build_batch
from voxelraytracing_tpu.resources.packs import Resources as JResources
from voxelraytracing_tpu.resources.packs import builtin_respack_path as j_respack
from voxelraytracing_tpu.server.world import ServerWorld as JServerWorld
from voxelraytracing_tpu.world.demo import demo_chunk_grids as j_demo_grids
from voxelraytracing_tpu.worldgen import WorldGen as JWorldGen
from voxelraytracing_tpu.worldgen.features import choose_features as j_choose
from voxelraytracing_tpu_torch.core import native
from voxelraytracing_tpu_torch.core.constants import NODES_PER_CHUNK
from voxelraytracing_tpu_torch.ops import noise
from voxelraytracing_tpu_torch.ops.svo_build import (
    build_chunk_svo, build_chunk_svo_batch)
from voxelraytracing_tpu_torch.resources.packs import (
    Resources, builtin_respack_path)
from voxelraytracing_tpu_torch.server import ServerWorld
from voxelraytracing_tpu_torch.world.demo import (
    demo_chunk_grids, demo_chunk_grids_host)
from voxelraytracing_tpu_torch.worldgen import WorldGen
from jax_op_by_op import numpy_op_by_op
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

CPU = dict(device="cpu")
PRESET_SEED = 20260816  # config2/config3's world (benchmarks/run.py:283)
KINDS = ("random", "uniform", "checkerboard", "terrain", "octants")


def _grids():
    rng = np.random.default_rng(21)
    g = np.zeros((len(KINDS), 32, 32, 32), np.int32)
    g[0] = (rng.random((32, 32, 32)) < 0.05) * rng.integers(1, 9, (32, 32, 32))
    g[1] = 7
    g[2] = np.indices((32, 32, 32)).sum(0) % 2  # every node splits
    h = rng.integers(4, 28, (32, 32))
    g[3] = np.where(np.arange(32)[None, :, None] < h[:, None, :], 1, 0)
    g[3, :, 20:22] = np.where(g[3, :, 20:22] == 0, 4, g[3, :, 20:22])
    g[4, :16, :16, :16], g[4, 16:, 16:, 16:] = 3, 5  # two uniform octants
    return g


@pytest.fixture(scope="module")
def svo_cases():
    """The grids, JAX's batch build of them (one program) and the port's."""
    g = _grids()
    jn, jc = j_build_batch(jnp.asarray(g))
    tn, tc = build_chunk_svo_batch(g, **CPU)
    return g, np.asarray(jn), np.asarray(jc), tn.numpy(), tc.numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_svo_build_equals_jax(svo_cases, kind):
    """One chunk through the port's ``build_chunk_svo``: JAX's nodes and
    count word for word, and nothing past the count, where the writes
    of cells that do not exist were dropped (JAX's ``mode="drop"``, the
    port's spare slot)."""
    g, jn, jc, _, _ = svo_cases
    i = KINDS.index(kind)
    nodes, n = build_chunk_svo(torch.from_numpy(g[i]), **CPU)
    assert nodes.dtype == torch.int32 and nodes.shape == (NODES_PER_CHUNK,)
    assert int(n) == int(jc[i])
    np.testing.assert_array_equal(nodes.numpy(), jn[i])
    assert not nodes[int(n):].any()
    if kind == "uniform":
        assert int(n) == 1 and int(nodes[0]) == 7
    if kind == "checkerboard":
        assert int(n) == NODES_PER_CHUNK


def test_svo_batch_equals_jax_and_native(svo_cases):
    """The batch equals JAX's batch and the native host builder word for
    word (the checkerboard needs more than the 15-bit child pointer: the
    native builder refuses it, the functional builders lay it out
    anyway)."""
    g, jn, jc, tn, tc = svo_cases
    assert tc.dtype == np.int32
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, jc)
    ok = [i for i, k in enumerate(KINDS) if k != "checkerboard"]
    nn, nc = native.dense_to_svo_batch(g[ok])
    np.testing.assert_array_equal(tn[ok], nn)
    np.testing.assert_array_equal(tc[ok], nc)
    with pytest.raises(MemoryError):
        native.dense_to_svo_batch(g[KINDS.index("checkerboard")][None])
    # a uint8 tensor batch (WorldGen's as_u8 grids) builds the same
    u8n, u8c = build_chunk_svo_batch(torch.from_numpy(g[ok].astype(np.uint8)),
                                     **CPU)
    np.testing.assert_array_equal(u8n.numpy(), nn)
    np.testing.assert_array_equal(j_build(jnp.asarray(g[0]))[0], jn[0])


def test_noise_sampler_equals_jax():
    """perlin2d, sample01, MappedNoise and RawNoise on seeded positions
    (negative, fractional, large) equal JAX's sampler op by op."""
    rng = np.random.default_rng(22)
    pos = np.concatenate([rng.normal(0, 300, (500, 2)),
                          rng.uniform(-4e5, 4e5, (500, 2))]).astype(np.float32)
    perm = noise.make_permutation(99)
    m = noise.Map(0.0137, 61.5, -3.25)
    t = torch.from_numpy(pos)
    with jax.disable_jit():
        jp = j_noise.perlin2d(jnp.asarray(perm), pos)
        js = j_noise.sample01(jnp.asarray(perm), pos)
        jm = j_noise.MappedNoise.from_seed(5, j_noise.Map(*m.__dict__.values()))
        jr = j_noise.RawNoise.from_seed(6)
        want = [jp, js, jm.sample(pos), jr.sample(pos),
                jr.map_sample(pos, jm.map)]
    got = [noise.perlin2d(perm, t), noise.sample01(perm, t),
           noise.MappedNoise.from_seed(5, m).sample(t),
           noise.RawNoise.from_seed(6).sample(t),
           noise.RawNoise.from_seed(6).map_sample(t, m)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(noise.sample01(perm, t).numpy(),
                                  noise.sample01_np(perm, pos))


@pytest.fixture(scope="module")
def packs():
    return (JResources.load_from(j_respack()).datapacks["terra"],
            Resources.load_from(builtin_respack_path()).datapacks["terra"])


def _positions(gen):
    """Four chunks around the preset's land: surface, a neighbour, one
    below the surface and one far away."""
    x, h, z = gen.find_land_near(0, 0) or (0, 64, 0)
    cx, cy, cz = x // 32, h // 32, z // 32
    return np.array([(cx, cy, cz), (cx + 1, cy, cz), (cx, cy - 1, cz + 3),
                     (-5, 2, 7)])


def _eager(jgen, pos):
    grids, aux = _op_by_op(jgen)(jnp.asarray(pos, jnp.int32))
    return np.asarray(grids), {k: np.asarray(v) for k, v in aux.items()}


def _op_by_op(jgen):
    """JAX's terrain pass of ``jgen`` evaluated op by op; it also stands
    in for the jitted pass ``generate_chunks`` runs."""
    terrain = numpy_op_by_op(jgen.terrain._generate_impl)
    jgen.terrain._generate = terrain
    return terrain


@pytest.mark.parametrize("preset,seed", [
    ("Continents", 1234), ("Continents", PRESET_SEED),
    ("Flatland", 1234), ("Flatland", PRESET_SEED)])
def test_generate_chunks_equal_jax(packs, preset, seed):
    """Grids, aux maps and features of four chunks equal JAX's (its terrain
    pass evaluated one primitive at a time, ``numpy_op_by_op``, the rest
    under ``jax.disable_jit()``); ``find_land_near``, ``terrain_h_at``
    and ``biome_at`` too."""
    jdp, tdp = packs
    jgen = JWorldGen.from_datapack(jdp, seed, preset)
    tgen = WorldGen.from_datapack(tdp, seed, preset, **CPU)
    with jax.disable_jit():
        land = jgen.find_land_near(0, 0)
        probes = [(jgen.terrain_h_at(x, z), jgen.biome_at(x, z).name)
                  for x, z in ((0, 0), (-77, 913), (5000, -12))]
    assert tgen.find_land_near(0, 0) == land
    assert [(tgen.terrain_h_at(x, z), tgen.biome_at(x, z).name)
            for x, z in ((0, 0), (-77, 913), (5000, -12))] == probes
    pos = _positions(jgen)
    jg, jaux = _eager(jgen, pos)
    grids, feats = tgen.generate_chunks(pos)
    assert grids.dtype == torch.int32 and grids.device.type == "cpu"
    np.testing.assert_array_equal(grids.numpy(), jg)
    _, aux = tgen.terrain.generate_grids(pos)
    for k, v in jaux.items():
        assert aux[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(aux[k].numpy(), v, k)
    jfeats = [j_choose(jgen, p, {k: v[i] for k, v in jaux.items()})
              for i, p in enumerate(pos)]
    assert [len(f) for f in feats] == [len(f) for f in jfeats]
    for fa, fb in zip(feats, jfeats):
        for a, b in zip(fa, fb):
            assert a.voxels == b.voxels
            np.testing.assert_array_equal(a.min, b.min)
            np.testing.assert_array_equal(a.max, b.max)
    u8, _ = tgen.generate_chunks(pos, as_u8=True)
    assert u8.dtype == torch.uint8
    np.testing.assert_array_equal(u8.numpy(), jg.astype(np.uint8))


def test_jitted_path_counted(packs):
    """Against JAX's jitted ``TerrainGen._generate`` (what its
    ``generate_chunks`` runs) on the preset world's seed: XLA contracts
    the noise's multiply-adds into FMAs, so ``veg_prob`` rounds apart in
    1,296 of the 4,096 columns (measured), by at most 1e-6 (measured
    4.3e-7; near 0 that is tens of ulps), and a knife-edge column could
    move a voxel of ``height`` or flip a ``peak``: 0 of each measured here
    (Flatland seed 1234 flips 2 peaks). The grids are equal."""
    jdp, tdp = packs
    jgen = JWorldGen.from_datapack(jdp, PRESET_SEED)
    tgen = WorldGen.from_datapack(tdp, PRESET_SEED, **CPU)
    pos = _positions(jgen)
    jg, jaux = jgen.terrain.generate_grids(pos)
    g, aux = tgen.terrain.generate_grids(pos)
    cols = {k: int((np.asarray(jaux[k]) != aux[k].numpy()).sum()) for k in aux}
    assert int((np.asarray(jg) != g.numpy()).sum()) == 0
    assert cols["height"] <= 2 and cols["biome"] <= 2 and cols["peak"] <= 2
    assert 0 < cols["veg_prob"] <= 4096
    diff = np.abs(np.asarray(jaux["veg_prob"]) - aux["veg_prob"].numpy())
    assert diff.max() <= 1e-6, diff.max()


def test_demo_chunk_grids_equal(packs):
    """The device demo builder equals its host twin (8 and 27 chunks, a
    window off the origin) and JAX's builder (8 chunks)."""
    perm = noise.make_permutation(7)
    for w, mn in ((2, (0, 0, 0)), (3, (-2, 1, 5))):
        args = (w, w * 32 * 0.45, int(w * 32 * 0.28))
        grids, cells = demo_chunk_grids(perm, mn, *args, **CPU)
        hg, hc = demo_chunk_grids_host(perm, np.asarray(mn), *args)
        assert grids.dtype == torch.int32 and cells.dtype == torch.int32
        np.testing.assert_array_equal(grids.numpy(), hg)
        np.testing.assert_array_equal(cells.numpy(), hc)
    grids, cells = demo_chunk_grids(perm, (0, 0, 0), 2, 28.8, 17, **CPU)
    jg, jc = numpy_op_by_op(lambda: j_demo_grids(
        jnp.asarray(perm), jnp.asarray((0, 0, 0), jnp.int32), 2,
        jnp.float32(28.8), jnp.int32(17)))()
    np.testing.assert_array_equal(grids.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(cells.numpy(), np.asarray(jc))


def test_server_world_equals_jax(packs):
    """``ServerWorld``: a batch generated, its features placed where
    every spanned chunk exists, an edit, and the SVO rebuild, all equal
    JAX's; a chunk read from ``fs`` is decoded by the native library."""
    jdp, tdp = packs
    jgen = JWorldGen.from_datapack(jdp, PRESET_SEED)
    tgen = WorldGen.from_datapack(tdp, PRESET_SEED, **CPU)
    x, h, z = tgen.find_land_near(0, 0)
    base = (x // 32, h // 32, z // 32)
    pos = [(base[0] + i, base[1], base[2] + k) for i in (-1, 0) for k in (0, 1)]
    stored = native.dense_to_svo(np.full((32, 32, 32), 2, np.uint16))[0]

    class Fs:
        def read_chunk(self, p):
            return stored.astype(np.uint16) if p == (0, -9, 0) else None

    edit = tuple(np.asarray(base) * 32 + (1, 2, 3))
    jw, tw = JServerWorld(jgen), ServerWorld(tgen)
    _op_by_op(jgen)
    with jax.disable_jit():  # the generation; the SVO build is integer
        jdone = jw.generate_chunks(pos + [(0, -9, 0)], fs=Fs())
    jtouched = jw.place_features()
    jw.set_voxel(edit, 9)
    jnodes = jw.build_nodes(pos + [(0, -9, 0)])
    done = tw.generate_chunks(pos + [(0, -9, 0)], fs=Fs())
    touched = tw.place_features()
    tw.set_voxel(edit, 9)
    nodes_ = tw.build_nodes(pos + [(0, -9, 0)])
    assert done == jdone and touched == jtouched
    assert len(tw.unplaced_features) == len(jw.unplaced_features)
    assert sorted(tw.chunks) == sorted(jw.chunks)
    for p in tw.chunks:
        np.testing.assert_array_equal(tw.chunks[p].grid, jw.chunks[p].grid)
        assert tw.chunks[p].dirty == jw.chunks[p].dirty
    assert nodes_.keys() == jnodes.keys()
    for p in nodes_:
        assert nodes_[p].dtype == np.uint16
        np.testing.assert_array_equal(nodes_[p], jnodes[p])
    assert tw.get_voxel(edit) == jw.get_voxel(edit) == 9


def test_entry_points_raise_without_a_card(packs):
    """With no CUDA card, worldgen, the demo builder and the SVO build
    raise unless the caller asks for the CPU: no fallback hides the
    device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    _, tdp = packs
    grids = np.zeros((1, 32, 32, 32), np.int32)
    for call in (lambda: WorldGen.from_datapack(tdp, 1),
                 lambda: demo_chunk_grids(noise.make_permutation(7),
                                          (0, 0, 0), 1, 14.4, 8),
                 lambda: build_chunk_svo_batch(grids),
                 lambda: build_chunk_svo(grids[0])):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
