"""The port's SVO tracer (``ops/traverse.py``) against the JAX package's.

Scenes: tests/test_tracer.py's chunk (floor, pool, pillar) at 48x48, and
a 4-chunk demo world from ``make_demo_world`` at test_wavefront4.py's
four CAMS at 64x32; both worlds are built by each package's own builders
and equal word for word.

Bars, each with its reason:
  * against JAX's program evaluated one primitive at a time (every
    multiply and add rounded on its own, the port's order: NumPy's
    ``tests/jax_op_by_op.py:numpy_op_by_op``, held on the chunk scene to
    ``jax.disable_jit()``, which rounds alike but dispatches and compiles
    each primitive on its own): every field word for word;
  * against JAX's jitted ``trace_rays``: hits and voxel ids equal, the
    other fields counted. XLA contracts ``a*b+c`` into FMAs there, which
    moves positions and step lengths by ulps; measured on these five
    scenes (10,496 rays): 0 hit and 0 voxel mismatches, 1 step count, 1
    normal component apart numerically (4,671 normal words apart, the
    rest the sign of a zero), 1,193 position words, 203 water distances;
  * against the scalar oracle (tests/reference_tracer.py), as
    test_tracer.py:59-94 holds JAX: hits, steps, voxels and normals exact,
    positions and water within 1e-3;
  * the port's SVO tracer against its own v4 trace
    (``trace_wavefront4_rays``, plain version) on the same rays: hit masks
    and voxel ids on common hits equal, as test_wavefront4.py:49-66
    asserts for JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelraytracing_tpu.ops import traverse as jtrav
from voxelraytracing_tpu.ops.svo_build import build_chunk_svo as j_build_chunk_svo
from voxelraytracing_tpu.world.demo import make_demo_world as j_make_demo_world
from voxelraytracing_tpu.world.pool import build_world_slice as j_build_world_slice

from voxelraytracing_tpu_torch.ops import traverse
from voxelraytracing_tpu_torch.ops.camera import CamData, generate_rays
from voxelraytracing_tpu_torch.ops.materials import make_material_table
from voxelraytracing_tpu_torch.ops.svo_build import build_chunk_svo
from voxelraytracing_tpu_torch.ops.wavefront3 import build_render_grid3_host
from voxelraytracing_tpu_torch.ops.wavefront4 import trace_wavefront4_rays
from voxelraytracing_tpu_torch.world.demo import (
    demo_chunk_grids_host, demo_materials, make_demo_world)
from voxelraytracing_tpu_torch.world.pool import build_world_slice
from voxelraytracing_tpu_torch.ops import noise

from jax_op_by_op import numpy_op_by_op
from reference_tracer import trace_one
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

CPU = dict(device="cpu")
AIR, STONE, WATER, GRASS = 0, 1, 2, 3
CAMS = [
    ((30.0, 45.0, 0.0), (64.0, 75.0, 64.0)),
    ((5.0, 120.0, 0.0), (20.0, 40.0, 100.0)),
    ((60.0, 200.0, 0.0), (100.0, 110.0, 30.0)),
    ((-20.0, 300.0, 0.0), (64.0, 20.0, 64.0)),  # underwater, looking up
]
# jitted JAX vs the port, summed over the five scenes (module docstring)
JIT_POS_WORDS, JIT_WATER, JIT_STEPS, JIT_NORM = 1193, 203, 1, 1


def _test_chunk():
    g = np.zeros((32,) * 3, dtype=np.int32)
    g[:, :8, :] = STONE
    g[:, 8, :] = GRASS
    g[4:12, 8:12, 4:12] = WATER  # pool
    g[20:23, 9:17, 20:23] = STONE  # pillar
    return g


@pytest.fixture(scope="module")
def scenes():
    """name -> (port world, JAX world, materials, [(origin, dirs)])."""
    g = _test_chunk()
    nodes, n = build_chunk_svo(g, **CPU)
    world, _ = build_world_slice({(0, 0, 0): nodes[:int(n)].numpy()},
                                 (0, 0, 0), 1, **CPU)
    jn, jc = j_build_chunk_svo(g)
    jworld, _ = j_build_world_slice({(0, 0, 0): np.asarray(jn)[:int(jc)]},
                                    (0, 0, 0), 1)
    mats = make_material_table(4, {
        AIR: {"state": "gas", "color": (0, 0, 0)},
        STONE: {"state": "solid", "color": (0.4, 0.4, 0.4)},
        WATER: {"state": "liquid", "color": (0.076, 0.563, 0.563)},
        GRASS: {"state": "solid", "color": (0.18, 0.45, 0.09)},
    })
    cam = CamData.create((35.0, 30.0, 0.0), (16.0, 24.0, 16.0), 70.0, (48, 48))
    out = {"chunk": (world, jworld, mats,
                     [generate_rays(cam, np.zeros(3), **CPU)])}
    demo = make_demo_world(7, 4, **CPU)
    rays = [generate_rays(CamData.create(r, e, 70.0, (64, 32)), np.zeros(3),
                          **CPU) for r, e in CAMS]
    out["demo"] = (demo, j_make_demo_world(7, 4), demo_materials(), rays)
    return out


def _jax_trace(jworld, mats, origin, dirs, max_steps=500):
    return jtrav.trace_rays(jworld, mats.is_liquid, jnp.asarray(origin.numpy()),
                            jnp.asarray(dirs.numpy()), max_steps)


def _jax_trace_op_by_op(jworld, mats, origin, dirs, max_steps=500):
    """JAX's trace, one primitive at a time (``numpy_op_by_op``)."""
    return numpy_op_by_op(lambda: _jax_trace(jworld, mats, origin, dirs,
                                         max_steps))()


def _words(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _differ(port, ref):
    """Differing words of each TraceResult field."""
    return {f: int((_words(getattr(ref, f))
                    != _words(getattr(port, f).numpy())).sum())
            for f in port._fields}


def test_worlds_equal_jax_word_for_word(scenes):
    for name, (world, jworld, _, _) in scenes.items():
        for f in ("nodes", "chunk_roots", "world_min"):
            np.testing.assert_array_equal(getattr(world, f).numpy(),
                                          np.asarray(getattr(jworld, f)),
                                          err_msg=f"{name} {f}")


@pytest.mark.parametrize("scene,ray", [("chunk", 0)] + [
    ("demo", i) for i in range(len(CAMS))])
def test_trace_equals_jax_without_jit(scenes, scene, ray):
    world, jworld, mats, rays = scenes[scene]
    origin, dirs = rays[ray]
    rs = traverse.trace_rays(world, mats.is_liquid, origin, dirs)
    ref = _jax_trace_op_by_op(jworld, mats, origin, dirs)
    assert _differ(rs, ref) == dict.fromkeys(rs._fields, 0)
    assert rs.hit.any()
    if scene == "chunk":
        with jax.disable_jit():
            eager = _jax_trace(jworld, mats, origin, dirs)
        assert _differ(rs, eager) == dict.fromkeys(rs._fields, 0)


def test_trace_against_jitted_jax_counted(scenes):
    """JAX's jitted trace_rays: the FMA contraction's mismatches, counted."""
    total = dict.fromkeys(traverse.TraceResult._fields, 0)
    num = {"norm": 0}
    jit_trace = jax.jit(jtrav.trace_rays, static_argnums=(4,))
    for world, jworld, mats, rays in scenes.values():
        for origin, dirs in rays:
            rs = traverse.trace_rays(world, mats.is_liquid, origin, dirs)
            ref = jit_trace(jworld, mats.is_liquid,
                            jnp.asarray(origin.numpy()),
                            jnp.asarray(dirs.numpy()), 500)
            for f, n in _differ(rs, ref).items():
                total[f] += n
            num["norm"] += int((np.asarray(ref.norm) != rs.norm.numpy()).sum())
    assert total["hit"] == 0 and total["voxel"] == 0
    assert num["norm"] <= JIT_NORM
    assert total["steps"] <= JIT_STEPS
    assert total["pos"] <= JIT_POS_WORDS and total["water_dist"] <= JIT_WATER


def test_trace_matches_scalar_oracle(scenes):
    world, _, mats, rays = scenes["chunk"]
    origin, dirs = rays[0]
    rs = traverse.trace_rays(world, mats.is_liquid, origin, dirs)
    nodes, roots = world.nodes.numpy(), world.chunk_roots.numpy()
    o, d = origin.numpy(), dirs.numpy()
    hit, voxel, norm, pos, water, steps = (x.numpy() for x in rs)
    n_hits = 0
    for py in range(48):
        for px in range(48):
            ref = trace_one(nodes, roots, 1, o, d[py, px], mats.is_liquid)
            at = f"pixel ({px},{py})"
            assert bool(hit[py, px]) == ref["hit"], at
            assert int(steps[py, px]) == ref["steps"], at
            np.testing.assert_allclose(water[py, px], ref["water_dist"],
                                       atol=1e-3, err_msg=at)
            if ref["hit"]:
                n_hits += 1
                assert int(voxel[py, px]) == ref["voxel"], at
                np.testing.assert_array_equal(norm[py, px], ref["norm"],
                                              err_msg=at)
                np.testing.assert_allclose(pos[py, px], ref["pos"],
                                           atol=1e-3, err_msg=at)
    assert 0 < n_hits < 48 * 48
    assert (water > 0).any()


def test_packed_pool_traces_equal(scenes):
    """Two u16 nodes a u32 word (shader.rs:22-40) trace word for word as
    the widened pool, on both packages' layouts."""
    for world, jworld, mats, rays in scenes.values():
        pw = world.packed()
        assert pw.nodes.dtype == torch.uint32
        assert pw.nodes.shape[0] == (world.nodes.shape[0] + 1) // 2
        np.testing.assert_array_equal(pw.nodes.view(torch.int32).numpy(),
                                      np.asarray(jtrav.pack_nodes(
                                          jworld.nodes)).view(np.int32))
        assert pw.packed() is pw
        origin, dirs = rays[0]
        a = traverse.trace_rays(world, mats.is_liquid, origin, dirs)
        b = traverse.trace_rays(pw, mats.is_liquid, origin, dirs)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("max_steps", [0, 1, 500])
def test_step_caps(scenes, max_steps):
    """A cap of 0 reports every ray that starts inside as a hit on voxel
    0; a cap of 1 takes one step; each equals JAX without jit."""
    world, jworld, mats, rays = scenes["demo"]
    origin, dirs = rays[1]
    rs = traverse.trace_rays(world, mats.is_liquid, origin, dirs, max_steps)
    ref = _jax_trace_op_by_op(jworld, mats, origin, dirs, max_steps)
    assert _differ(rs, ref) == dict.fromkeys(rs._fields, 0)
    assert int(rs.steps.max()) == min(max_steps, int(rs.steps.max()))
    if max_steps == 0:
        assert bool(rs.hit.all()) and not rs.voxel.any()


def test_camera_outside_and_axis_aligned_rays(scenes):
    """A camera outside the world sees nothing; axis-aligned rays (zero
    direction components, the guarded ratios) equal JAX without jit. Zero
    signs decide these rays, so the op-by-op evaluation is also held to
    ``jax.disable_jit()`` word for word here."""
    world, jworld, mats, _ = scenes["demo"]
    cam = CamData.create((30.0, 45.0, 0.0), (-50.0, 75.0, 64.0), 70.0, (64, 32))
    origin, dirs = generate_rays(cam, np.zeros(3), **CPU)
    rs = traverse.trace_rays(world, mats.is_liquid, origin, dirs)
    assert not rs.hit.any() and not rs.steps.any()
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    dirs = torch.from_numpy(np.repeat(axes, 2, axis=0))
    origins = torch.tensor([[64.5, 70.25, 64.5], [127.5, 40.0, 0.5]] * 6)
    rs = traverse.trace_rays(world, mats.is_liquid, origins, dirs)
    ref = _jax_trace_op_by_op(jworld, mats, origins, dirs)
    assert _differ(rs, ref) == dict.fromkeys(rs._fields, 0)
    assert rs.hit.any() and not rs.hit.all()
    with jax.disable_jit():
        eager = _jax_trace(jworld, mats, origins, dirs)
    assert _differ(rs, eager) == dict.fromkeys(rs._fields, 0)


def test_sync_interval_changes_no_word(scenes):
    """The loop that tests any(active) every k iterations equals the one
    that tests it every iteration: finished rays are frozen."""
    world, _, mats, rays = scenes["demo"]
    for origin, dirs in rays:
        a = traverse.trace_rays(world, mats.is_liquid, origin, dirs,
                                sync_every=1)
        for k in (3, 64):
            b = traverse.trace_rays(world, mats.is_liquid, origin, dirs,
                                    sync_every=k)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), k


@pytest.fixture(scope="module")
def rg3():
    w = 4
    grids, cells = demo_chunk_grids_host(
        noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    return build_render_grid3_host(grids, cells, np.zeros(3, np.int32), w,
                                   demo_materials(), **CPU)


@pytest.mark.parametrize("cam", range(len(CAMS)))
def test_svo_tracer_agrees_with_port_v4(scenes, rg3, cam):
    """The port's SVO tracer and its v4 bundle trace on the same rays: hit
    masks and voxel ids on common hits equal (test_wavefront4.py:49-66)."""
    world, _, mats, rays = scenes["demo"]
    origin, dirs = rays[cam]
    ref = traverse.trace_rays(world, mats.is_liquid, origin, dirs)
    wf = trace_wavefront4_rays(rg3, origin.expand(32, 64, 3), dirs,
                               torch.ones(32, 64, dtype=torch.bool),
                               width=64, height=32, step_cap=500)
    assert torch.equal(ref.hit, wf.hit)
    m = ref.hit & wf.hit
    assert torch.equal(ref.voxel[m], wf.voxel[m])
    wd = (ref.water_dist - wf.water_dist).abs()
    assert float(wd.median()) < 0.05
