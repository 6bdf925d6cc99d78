"""The port's engine session (``engine/``) and its UI and input state, the
counterparts of tests/test_engine_app.py and tests/test_engine_ui.py, on
the CPU.

World: test_engine_app.py's "Flat" world (terra, seed 7), served by the
port's server: once as ``EngineApp.host_singleplayer``'s child process
(``servercli`` on the CPU, the one subprocess of these tests), else in a
thread of this process (tests/torch_served.py). Windows of 4³ chunks,
128x64 frames.

Bars, each with its reason:
  * the fused v4 fast frame against JAX's ``render_frame4(fused=True)`` on
    the engine builder's tables: flags exactly equal, every hit pixel's
    packed word exactly equal, a sky channel within 1/255 (the two libms
    may round ``** 0.35`` apart; tests/test_torch_frame.py);
  * the SVO frame against JAX's jitted ``RayTracer`` on the engine's node
    pool: hits and voxel ids exactly equal, every channel within 2e-5
    (measured 8.4e-6 on 3 of 24,576 channels, 6.6e-7 elsewhere: XLA
    contracts ``a*b+c`` under ``jit``, which moves hit positions and water
    lengths by ulps, tests/test_torch_traverse.py, and the water overlay
    scales a length by 1/14; the libms round the sky gradient's ``**
    0.35`` apart). Without jit the hits are word for word
    (tests/test_torch_renderers.py), at 8 s a frame here;
  * the v3 fast frame against the port's ``render_frame3`` on a fresh
    one-shot build of the same window (the v3 frame is held to JAX in
    tests/test_torch_v3_render.py): word for word.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelraytracing_tpu.models import raytracer as jrt
from voxelraytracing_tpu.ops import materials as jmat
from voxelraytracing_tpu.ops import traverse as jtr
from voxelraytracing_tpu.ops import wavefront3 as j3
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.ops.wavefront4 import render_frame4 as j_render_frame4

from voxelraytracing_tpu_torch.client import PlayerInput
from voxelraytracing_tpu_torch.engine import EngineApp
from voxelraytracing_tpu_torch.engine.input import InputState
from voxelraytracing_tpu_torch.engine.ui import Page, UiState
from voxelraytracing_tpu_torch.models import composite_crosshair
from voxelraytracing_tpu_torch.ops import noise
from voxelraytracing_tpu_torch.ops import wavefront3 as t3
from voxelraytracing_tpu_torch.ops.wavefront4 import prepare_grid4
from voxelraytracing_tpu_torch.resources.packs import Resources
from voxelraytracing_tpu_torch.utils.profiling import (
    FrameProfiler, device_memory_stats, device_trace, ray_stats, trace_path)
from voxelraytracing_tpu_torch.world.demo import (
    demo_chunk_grids_host, demo_materials)
from voxelraytracing_tpu_torch.world.render_grid import RenderGrid3Builder

from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)
from torch_served import ServedWorld, flat_root, stream_window

SESSION = dict(resolution=(128, 64), world_size_chunks=4, device="cpu",
               max_nodes=1 << 20)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = flat_root(tmp_path_factory.mktemp("engine"))
    sw = ServedWorld(root)
    yield root, sw
    sw.stop()


def _join(served, name, **kw):
    root, sw = served
    app = EngineApp.join(("127.0.0.1", sw.port), name, resource_root=root,
                         **{**SESSION, **kw})
    stream_window(app)
    return app


def _fall(app):
    for _ in range(120):
        app.update_input(PlayerInput())
        if app.game.player.on_ground:
            break
    return app.game.player.on_ground


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_cam(app):
    p = app.game.player
    return JCamData.create(tuple(p.rot), tuple(p.cam_pos), p.fov,
                           app.resolution)


def _jax_materials(mats):
    return jmat.MaterialTable(*(jnp.asarray(np.asarray(x)) for x in mats))


def test_singleplayer_session(served, monkeypatch):
    """test_engine_app.py's session: a server child process on the CPU,
    the window streamed, the player on the ground, the SVO frame (equal to
    JAX's ``RayTracer`` on the engine's node pool), pick, break and place,
    the overlay, the heatmap, the palette, ``InputState`` and the fps
    cap."""
    root, _ = served
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    app = EngineApp.host_singleplayer(root, "Flat", port=_free_port(),
                                      **SESSION)
    try:
        assert not app.fast_path  # the CPU keeps the SVO tracer
        assert stream_window(app) == 64
        assert _fall(app)

        app.crosshair.style = "off"
        # off the axes, as in test_engine_fast_path_v4
        app.game.player.rot = np.asarray([20.0, 35.0, 0.0], np.float32)
        img = app.draw_frame()
        assert img.shape == (64, 128, 3) and img.device.type == "cpu"
        assert not torch.isnan(img).any()
        assert float(app._last_trace.hit.float().mean()) > 0.1
        world = app.world_slice()
        jworld = jtr.WorldSlice(*(jnp.asarray(x.numpy()) for x in world))
        jimg, jrs = jrt.RayTracer(_jax_materials(app.materials)).render(
            jworld, _jax_cam(app), jrt.RenderSettings(
                sun_pos=app.settings.sun_pos))
        rs = app._last_trace
        assert np.array_equal(rs.hit.numpy(), np.asarray(jrs.hit))
        assert np.array_equal(rs.voxel.numpy(), np.asarray(jrs.voxel))
        np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=0,
                                   atol=2e-5)
        app.crosshair.style = "cross"

        # look down, break the block under the crosshair
        app.game.player.rot = np.asarray([85.0, 0.0, 0.0], np.float32)
        hit = app.pick()
        assert hit is not None
        pos, face = hit
        grass = app.game.voxels.by_name("grass")
        assert app.game.world.get_voxel(pos) == grass
        assert app.break_voxel()
        assert app.game.world.get_voxel(pos) == 0
        # place it back against the face below
        app.placing_voxel = app.game.voxels.by_name("stone")
        assert app.place_voxel()

        ov = app.debug_overlay()
        assert ov["chunks_populated"] == 64
        assert 0.0 < ov["node_space_used_frac"] < 1.0

        app.toggle_step_heatmap()
        img2 = app.draw_frame()
        assert not torch.isnan(img2).any()

        v0 = app.placing_voxel
        v1 = app.cycle_placing_voxel(1)
        assert v1 != v0 and app.game.voxels.get(v1).is_solid
        app.cycle_placing_voxel(-1)
        assert app.placing_voxel == v0

        inp = InputState()
        inp.scroll(1.0)
        inp.key_down("f9")
        app.apply_input_state(inp)
        assert app.placing_voxel != v0
        assert app.freeze_world_anchor
        assert inp.scroll_delta == 0.0  # edges cleared

        app.fps_cap = 0.01  # a second draw inside the cap window
        a = app.draw_frame()
        b = app.draw_frame()
        assert b is a
        app.fps_cap = None
    finally:
        app.close()
    assert app.server_program.proc.returncode == 0


def test_composite_crosshair_styles():
    """Blit-stage crosshair math (screen_shader.wgsl:43-65)."""
    img = torch.zeros((64, 64, 3), dtype=torch.float32)
    o = composite_crosshair(img, style="dot", size=4.0,
                            color=(1.0, 0.0, 0.0, 1.0))
    assert o[32, 32, 0] == 1.0 and o[32, 32, 1] == 0.0
    assert o[0, 0].sum() == 0.0
    o = composite_crosshair(img, style="cross", size=8.0,
                            color=(1.0, 1.0, 1.0, 0.5))
    assert abs(float(o[32, 36, 0]) - 0.5) < 1e-6
    assert abs(float(o[36, 32, 0]) - 0.5) < 1e-6
    assert o[38, 38].sum() == 0.0
    assert composite_crosshair(img, style="off") is img


def _demo(w=2):
    grids, cells = demo_chunk_grids_host(
        noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    cell_xyz = [(int(c % w), int((c // w) % w), int(c // (w * w)))
                for c in cells]
    return grids, cells, cell_xyz, demo_materials()


def test_render_grid_builder_matches_batch_build():
    """Incremental RenderGrid3Builder == the one-shot host builder, through
    install, eviction and a single-chunk install."""
    w = 2
    grids, cells, cell_xyz, mats = _demo(w)
    ref = t3.build_render_grid3_host(grids, cells, np.zeros(3, np.int32), w,
                                     mats, device="cpu")
    b = RenderGrid3Builder(w, mats, device="cpu")
    b.set_chunks(cell_xyz, grids)
    got = b.grid()
    for name in ("gw_jump", "gw_liq", "wmeta", "sw_meta", "sw_solid",
                 "sw_liq", "sw_pid"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    b.clear_cells(cell_xyz)
    got2 = b.grid()
    assert int(got2.sw_solid.sum()) == 0
    bits = got2.gw_jump.numpy().reshape(-1)
    jump = np.unpackbits(bits.view(np.uint8), bitorder="little")[:b.nw ** 3]
    assert jump.all()
    b.set_chunks(cell_xyz[:1], grids[:1])
    got3 = b.grid()
    ref3 = t3.build_render_grid3_host(grids[:1], np.asarray(cells)[:1],
                                      np.zeros(3, np.int32), w, mats,
                                      device="cpu")
    assert torch.equal(got3.sw_solid, ref3.sw_solid)
    assert torch.equal(got3.wmeta, ref3.wmeta)


def test_incremental_prepared_matches_oneshot():
    """Builder-maintained packed tables == ``prepare_grid4`` through
    install, edit and eviction."""
    grids, _, cell_xyz, mats = _demo()
    b = RenderGrid3Builder(2, mats, device="cpu")

    def check():
        got, ref = b.prepared(), prepare_grid4(b.grid())
        assert torch.equal(got.sw_cont, ref.sw_cont)
        assert torch.equal(got.wmeta_pad, ref.wmeta_pad)

    b.set_chunks(cell_xyz, grids)
    check()
    edited = np.array(grids[:1])
    edited[0, :, 16:, :] = 0
    b.set_chunks(cell_xyz[:1], edited)
    check()
    b.clear_cells(cell_xyz[1:2])
    check()


def _jax_grid(rg):
    """The port's RenderGrid3 as JAX's: bit tables as uint32 words."""
    planes = ("gw_jump", "gw_liq", "wmeta", "sw_meta", "sw_solid", "sw_liq",
              "sw_pid", "brick_dir", "bricks")
    return j3.RenderGrid3(**{
        f: (jnp.asarray(x.numpy().view(np.uint32)) if f in planes
            else jnp.asarray(x.numpy()) if torch.is_tensor(x) else x)
        for f, x in zip(rg._fields, rg)})


def test_engine_fast_path_v4(served):
    """The fast path on the fused v4 frame (one launch a frame): the
    engine's frame equals JAX's fused frame on the builder's tables; an
    edit reaches the incremental builder and the frame is redrawn."""
    app = _join(served, "v4", fast_path=True, fast_tracer="v4")
    try:
        assert _fall(app)
        # off the axes: the player's first view looks along one, where
        # XLA's contracted ray math moves JAX's faces (ROADMAP's platform
        # facts, the near-axis cameras)
        app.game.player.rot = np.asarray([20.0, 35.0, 0.0], np.float32)
        app.crosshair.style = "off"
        img = app.draw_frame()
        assert img.shape == (64, 128, 3)
        rs = app._last_trace
        assert float(rs.hit.float().mean()) > 0.1
        b = app._fast_builder()
        assert not b.sparse and app._v4_cache_key == (128, 64, False, 4,
                                                      False)
        s = app.settings
        jimg, jfl = j_render_frame4(
            _jax_grid(b.grid()), _jax_cam(app), app.materials.color,
            sky_color=s.sky_color, sun_pos=s.sun_pos,
            sun_intensity=s.sun_intensity, with_flags=True, fused=True)
        jimg, jfl = np.asarray(jimg), np.asarray(jfl)
        hit = ((jfl >> 1) & 1) != 0
        assert np.array_equal(rs.hit.numpy(), hit)
        packed = rs.packed.numpy().view(np.uint32)
        assert np.array_equal(packed[hit], jimg[hit])
        for sh in (0, 8, 16):
            d = np.abs(((packed >> sh) & 255).astype(int)
                       - ((jimg >> sh) & 255).astype(int))
            assert d.max() <= 1
        assert np.array_equal(rs.voxel.numpy()[hit], ((jfl >> 17) & 255)[hit])
        assert np.array_equal(rs.steps.numpy(), (jfl >> 5) & 0xFFF)
        want = torch.stack([(rs.packed >> k) & 0xFF for k in (0, 8, 16)],
                           dim=-1).to(torch.float32) / 255.0
        assert torch.equal(img, want)

        app.update_input(PlayerInput(cursor_movement=(0.0, 300.0)))
        assert app.pick() is not None and app.break_voxel()
        before = rs.packed.clone()
        img2 = app.draw_frame()
        assert not torch.isnan(img2).any()
        assert not torch.equal(app._last_trace.packed, before)
    finally:
        app.close()


def test_engine_fast_path_session(served):
    """The fast path on the v3 frame (at 64x32: the v3 round loop's plain
    version takes 1.7 s a 128x64 frame here): the engine's frame equals
    ``render_frame3`` on a one-shot build of the same window."""
    app = _join(served, "v3", fast_path=True, fast_tracer="v3",
                resolution=(64, 32))
    try:
        assert _fall(app)
        img = app.draw_frame()
        assert img.shape == (32, 64, 3)
        rs = app._last_trace
        assert float(rs.hit.float().mean()) > 0.1
        w = app.game.world
        cells = sorted(w.chunks)
        grids = np.stack([app._dense_chunk(w.chunks[c]) for c in cells])
        flat = [int(c[0] - w.min_chunk[0]) + 4 * int(c[1] - w.min_chunk[1])
                + 16 * int(c[2] - w.min_chunk[2]) for c in cells]
        rg = t3.build_render_grid3_host(
            grids, np.asarray(flat), np.asarray(w.min_voxel, np.int32), 4,
            app.materials, device="cpu")
        s = app.settings
        ref = t3.render_frame3(rg, app.camera(), app.materials.color,
                               sky_color=s.sky_color, sun_pos=s.sun_pos,
                               sun_intensity=s.sun_intensity)
        assert torch.equal(rs.packed, ref)
    finally:
        app.close()


def test_engine_resize(served):
    """A live resolution change re-renders at the new size."""
    app = _join(served, "resize")
    try:
        assert app.draw_frame().shape == (64, 128, 3)
        app.set_resolution(64, 32)
        img2 = app.draw_frame()
        assert img2.shape == (32, 64, 3) and not torch.isnan(img2).any()
    finally:
        app.close()


def test_client_pool_grows_when_full(served):
    """A full client pool doubles (``ClientWorld.grow_pool``): the window
    streams into a pool of 1,024 nodes, every chunk keeps its voxels, the
    device mirror follows, and the SVO frame equals that of a session whose
    pool never filled."""
    small = _join(served, "small", max_nodes=1 << 10, resolution=(64, 32))
    big = _join(served, "big", resolution=(64, 32))
    try:
        w, wb = small.game.world, big.game.world
        assert w.max_nodes > 1 << 10 and len(w.nodes) == w.max_nodes
        assert w.node_space_status()[1] == w.max_nodes
        assert sorted(w.chunks) == sorted(wb.chunks)
        for pos, chunk in w.chunks.items():
            np.testing.assert_array_equal(small._dense_chunk(chunk),
                                          big._dense_chunk(wb.chunks[pos]))
        assert torch.equal(small.world_slice().nodes,
                           torch.from_numpy(w.nodes))
        small.crosshair.style = big.crosshair.style = "off"
        big.game.player.pos = small.game.player.pos.copy()
        big.game.player.rot = small.game.player.rot.copy()
        img = small.draw_frame()
        assert float(small._last_trace.hit.float().mean()) > 0.1
        assert torch.equal(img, big.draw_frame())
    finally:
        small.close()
        big.close()


def test_engine_oversized_window_falls_back(served):
    """The fused path covers the slider's whole range (10..80): sparse
    tables past 32 chunks, ``resize_world`` clamped at 80."""
    app = _join(served, "wide", fast_path=True, resolution=(64, 32))
    try:
        real_req = app.game.request_missing_chunks
        app.game.request_missing_chunks = lambda: None
        app.resize_world(34)
        assert not app._fast_path_suspended
        assert app._fast_builder().sparse
        assert app.draw_frame().shape == (32, 64, 3)
        app.resize_world(80)
        assert not app._fast_path_suspended
        app.resize_world(999)
        assert app.game.world.size_in_chunks == 80
        assert not app._fast_path_suspended
        app.game.request_missing_chunks = real_req
        app.resize_world(4)
        assert not app._fast_path_suspended
        assert not app._fast_builder().sparse
        assert app.draw_frame().shape == (32, 64, 3)
    finally:
        app.close()


# ------------------------------------------------------------- UI, input


def test_page_stack_navigation():
    ui = UiState()
    assert ui.page == Page.TITLE
    ui.push(Page.OPTIONS)
    ui.push(Page.VISUALS)
    assert ui.page == Page.VISUALS
    ui.pop()
    assert ui.page == Page.OPTIONS
    ui.pop()
    ui.pop()  # can't pop past root
    assert ui.page == Page.TITLE
    assert "actions" in ui.view()


def test_world_create_and_list(tmp_path):
    root = flat_root(tmp_path)
    ui = UiState(resources=Resources.load_from(root))
    n0 = len(ui.worlds())
    ui.create_world("My Test World", seed=99)
    assert len(ui.worlds()) == n0 + 1
    w = next(x for x in ui.worlds() if x.name == "My Test World")
    assert w.seed == 99 and w.datapack == "terra"
    ui.create_world("My Test World", seed=1)  # a distinct folder
    assert len(ui.worlds()) == n0 + 2


def test_input_edges_and_bindings():
    inp = InputState()
    inp.key_down("W")
    inp.key_down("w")  # repeat: no new edge
    inp.key_down("f")
    inp.move_cursor(3.0, -2.0)
    pi = inp.to_player_input()
    assert pi.forward and pi.toggle_fly and pi.cursor_movement == (3.0, -2.0)
    inp.finish_frame()
    pi2 = inp.to_player_input()
    assert pi2.forward and not pi2.toggle_fly
    inp.key_up("w")
    assert not inp.to_player_input().forward


def test_frame_profiler_ray_stats_and_trace(tmp_path):
    prof = FrameProfiler()
    with prof.section("update"):
        pass
    assert "update" in prof.summary()

    class FakeRs:
        steps = torch.tensor([[1, 5], [3, 7]])
        hit = torch.tensor([[True, False], [True, True]])

    st = ray_stats(FakeRs())
    assert st["rays"] == 4 and st["steps_max"] == 7
    assert 0 < st["hit_fraction"] <= 1
    with device_trace(str(tmp_path)) as d:
        torch.ones(8).sum()
    assert d == str(tmp_path)
    assert "traceEvents" in open(trace_path(d)).read()
    mem = device_memory_stats()
    if torch.cuda.is_available():
        assert all("bytes_limit" in m for m in mem)
    else:
        assert mem == [{"device": "cpu"}]
