"""Interactive engine session: the app-shell analog, headless.

Port of ``voxelraytracing_tpu/engine/app.py``. The reference's desktop
shell (clientdesktop/src/main.rs:113-757) is a winit event loop marrying
game state, GPU buffers and egui. This engine has no window; this module
provides the same *frame loop* as an API — embedders (tools, tests,
notebook viewers, a future UI) drive it:

    app = EngineApp.host_singleplayer(resource_root, world_name)  # or join()
    app.update()                    # net pump + device uploads
    app.update_input(PlayerInput(forward=True), t_delta=1.0)
    app.update_game()               # recenter window + request chunks
    img = app.draw_frame()          # render -> f32[H,W,3] on the device

Feature parity with the shell's hotkeys/overlay is exposed as state:
``settings.show_step_count`` (F2 heatmap), ``freeze_world_anchor`` (F9),
``resize_world(n)`` (UI slider, 10..80), ``debug_overlay()`` (the egui
stats panel as a dict), and voxel picking/editing via ``pick()`` /
``place_voxel()`` / ``break_voxel()``.

The session renders on ``device`` (the card unless the caller asks for the
CPU): the node pool mirror, the fast path's tables and every frame live
there. On the card the fast path is on by default: the fused v4 frame,
one ``march_fused4`` launch a frame (or the v3 frame, ``fast_tracer="v3"``).
"""

import logging
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..client import ClientWorld, GameState, PlayerInput, ServerConn
from ..core.constants import CHUNK_SIZE
from ..core.math import cast_ray
from ..core.svo import NoChunk, PosOutOfBounds
from ..models.raytracer import RayTracer, RenderSettings, composite_crosshair
from ..ops.camera import CamData, _f32
from ..ops.materials import make_material_table
from ..ops.traverse import WorldSlice

# the client pool's first size, 16M nodes ≈ 64 MB host mirror; a full pool
# doubles (ClientWorld.grow_pool): terra's "Demo World" fills 60.7M nodes
# in a 30-chunk window
DEFAULT_MAX_NODES = 1 << 24
PICK_DISTANCE = 10.0  # voxel-edit reach (clientdesktop/src/main.rs:320-325)
FAST_PATH_MAX_W = 80  # fused-path window cap = the reference UI slider's
#                       ceiling (ui.rs:165). Past 32 chunks the builder
#                       switches to SPARSE packed tables (dense would be
#                       ~15 GB at 80; sparse is tens of MB on terrain) —
#                       world/render_grid.py RenderGrid3Builder.sparse.
SET_CHUNKS_BATCH = 512  # chunks a builder install takes at once

_log = logging.getLogger(__name__)


class Timers:
    """Frame-rate accounting (clientdesktop/src/main.rs:710-757)."""

    def __init__(self):
        self.last = time.monotonic()
        self.frame_count = 0
        self.fps = 0.0
        self._window_start = self.last

    def tick(self):
        now = time.monotonic()
        self.frame_count += 1
        if now - self._window_start >= 1.0:
            self.fps = self.frame_count / (now - self._window_start)
            self.frame_count = 0
            self._window_start = now
        dt = now - self.last
        self.last = now
        return dt


class ServerProgram:
    """Singleplayer host: the dedicated server as a child process, stopped
    by writing ``stop`` to its stdin (clientdesktop/src/main.rs:70-110)."""

    def __init__(self, proc):
        self.proc = proc

    @classmethod
    def host(cls, resource_root, world_name, port, device="cuda"):
        """Start ``python -m voxelraytracing_tpu_torch.tools.servercli``
        with its worldgen on ``device`` and wait for its listener."""
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH")) if p)
        proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "voxelraytracing_tpu_torch.tools.servercli",
                resource_root,
                world_name,
                str(port),
                str(device),
            ],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        # wait for the listener banner
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if "serving" in line:
                return cls(proc)
            if proc.poll() is not None:
                raise RuntimeError(f"server exited: {line}")
        proc.kill()
        raise TimeoutError("server did not start")

    def shutdown(self):
        try:
            self.proc.stdin.write("stop\n")
            self.proc.stdin.flush()
            self.proc.wait(timeout=60)
        except (OSError, subprocess.TimeoutExpired):
            self.proc.kill()
            self.proc.wait()


class EngineApp:
    """One running client session (rendering + game state) on ``device``."""

    def __init__(
        self,
        game: GameState,
        styles=None,
        resolution=(1280, 720),
        world_size_chunks=30,
        server_program=None,
        fast_path=None,
        fast_tracer="v4",
        device="cuda",
    ):
        self.game = game
        self.device = torch.device(device)
        self.resolution = tuple(resolution)
        self.server_program = server_program
        self.settings = RenderSettings(sun_pos=(0.0, 10_000.0, 0.0))
        self.freeze_world_anchor = False  # F9 analog
        self.timers = Timers()
        self.placing_voxel = 1  # scroll-wheel palette analog
        # redraw cap (frames/s) — the reference skips the redraw when
        # <1000/60 ms have elapsed (main.rs:682-690); None = uncapped.
        # A capped draw_frame() returns the previous frame unchanged.
        self.fps_cap = None
        self._last_draw_t = 0.0
        self._last_img = None
        self._styles = styles or {}
        self.materials = self._build_materials()
        self.tracer = RayTracer(self.materials)
        # fast path: the fused bit-plane frame over an incrementally
        # maintained RenderGrid3, on by default on the card; on the CPU
        # the kernels' plain versions are too slow for interactive
        # resolutions, so it keeps the SVO tracer unless asked.
        if fast_path is None:
            fast_path = self.device.type == "cuda"
        self.fast_path = bool(fast_path)
        # "v4" (default) = the fused v4 frame (one march_fused4 launch);
        # "v3" = the round-serviced v3 frame (march3 a round, shade4)
        assert fast_tracer in ("v3", "v4"), fast_tracer
        self.fast_tracer = fast_tracer
        # a window beyond the fused path's cap starts (not crashes) on
        # the SVO tracer; resize_world() re-enables
        self._fast_path_suspended = (
            self.fast_path and game.world.size_in_chunks > FAST_PATH_MAX_W
        )
        if self._fast_path_suspended:
            _log.warning(
                "initial window %d > %d chunks exceeds the fused path's "
                "table budget; rendering falls back to the SVO tracer",
                game.world.size_in_chunks, FAST_PATH_MAX_W,
            )
        self._rg_builder = None
        self._rg_min = None
        # the v4 frame's (inert) warm token keyed on (resolution, shadows,
        # window, sparse), as in JAX
        self._v4_cache = None
        self._v4_cache_key = None
        from .ui import CrosshairStyle

        self.crosshair = CrosshairStyle()
        self._dev_nodes = torch.tensor(game.world.nodes, device=self.device)
        self._dirty_spans = []
        self._last_trace = None

    # ------------------------------------------------------------ setup

    @classmethod
    def join(cls, addr, user_name, resource_root=None, stylepack="terra", **kw):
        """Connect to a running server (AppState::join_game,
        clientdesktop/src/main.rs:189-229)."""
        conn = ServerConn.establish(addr, user_name)
        center = np.floor_divide(np.asarray(conn.player_pos, np.int64), CHUNK_SIZE)
        world = ClientWorld(
            center,
            max_nodes=kw.pop("max_nodes", DEFAULT_MAX_NODES),
            size_in_chunks=kw.pop("world_size_chunks", 30),
        )
        game = GameState(user_name, world, conn)
        styles = cls._load_styles(resource_root, stylepack)
        return cls(game, styles=styles, **kw)

    @classmethod
    def host_singleplayer(
        cls, resource_root, world_name, user_name="player", port=60100, **kw
    ):
        """Spawn a local server child process on the engine's device and
        join it (clientdesktop/src/main.rs:231-245)."""
        prog = ServerProgram.host(resource_root, world_name, port,
                                  device=kw.get("device", "cuda"))
        try:
            app = cls.join(
                ("127.0.0.1", port), user_name, resource_root=resource_root, **kw
            )
        except Exception:
            prog.shutdown()
            raise
        app.server_program = prog
        return app

    @staticmethod
    def _load_styles(resource_root, stylepack):
        if resource_root is None:
            return {}
        from ..resources.packs import Resources

        res = Resources.load_from(resource_root)
        return res.stylepacks[stylepack].voxel_styles if stylepack in res.stylepacks else {}

    def _build_materials(self):
        styles = {}
        for vid in range(len(self.game.voxels)):
            vd = self.game.voxels.get(vid)
            st = self._styles.get(vd.name) if vd else None
            if st is not None:
                styles[vid] = {
                    "color": st.color,
                    "state": st.state,
                    "emission": st.emission,
                    "scatter": st.scatter,
                }
            elif vd is not None:
                styles[vid] = {"color": (0.5, 0.5, 0.5), "state": vd.state}
        return make_material_table(max(256, len(self.game.voxels)), styles)

    # ------------------------------------------------------------ frame loop

    def update(self, net_budget_s=0.2):
        """Net pump + device node uploads (main.rs:278-297)."""
        rs = self.game.process_cmds_timeout(net_budget_s)
        for pos, start, n in rs.updated_chunks:
            self._dirty_spans.append((start, n))
        if self.fast_path and self._rg_builder is not None and rs.updated_chunks:
            self._fast_set_chunks([pos for pos, _, _ in rs.updated_chunks])
        return rs

    # ------------------------------------------------------- fast path

    def _dense_chunk(self, chunk):
        """Decode a client chunk's SVO span to a dense 32³ pack-id grid."""
        from ..core import native

        w = self.game.world
        used = chunk.alloc.last_used_addr + 1
        return native.svo_to_dense(w.nodes[chunk.start:chunk.start + used])

    def _fast_set_chunks(self, positions):
        """Install the window's chunks at ``positions`` into the builder,
        :data:`SET_CHUNKS_BATCH` at a time (a 30-chunk window's first
        build would otherwise stack 27,000 dense grids at once)."""
        w = self.game.world
        cells, grids = [], []
        for pos in positions:
            chunk = w.chunks.get(tuple(int(a) for a in pos))
            if chunk is None or not w.in_window(pos):
                continue
            cell = tuple(
                int(a) for a in (np.asarray(pos, np.int64) - w.min_chunk)
            )
            cells.append(cell)
            grids.append(self._dense_chunk(chunk))
            if len(cells) == SET_CHUNKS_BATCH:
                self._rg_builder.set_chunks(cells, np.stack(grids))
                cells, grids = [], []
        if cells:
            self._rg_builder.set_chunks(cells, np.stack(grids))

    def _fast_builder(self):
        """RenderGrid3Builder tracking the client window on the engine's
        device; full rebuild on recenter/resize, incremental on chunk
        arrival/edit."""
        from ..world.render_grid import RenderGrid3Builder

        w = self.game.world
        if (
            self._rg_builder is None
            or self._rg_min is None
            or not np.array_equal(self._rg_min, w.min_chunk)
            or self._rg_builder.w != w.size_in_chunks
        ):
            self._rg_builder = RenderGrid3Builder(
                w.size_in_chunks, self.materials, world_min=w.min_voxel,
                # the engine renders only through prepared(): sparse
                # tables from 33 chunks (dense ~0.7 GB at 30 but grows
                # cubically; sparse is tens of MB)
                sparse=w.size_in_chunks > 32, device=self.device,
            )
            self._rg_min = np.asarray(w.min_chunk).copy()
            self._fast_set_chunks(list(w.chunks.keys()))
        return self._rg_builder

    def update_input(self, inp: PlayerInput, t_delta=1.0):
        """Player physics (main.rs:299-396)."""
        p = self.game.player
        mv = p.process_input(t_delta, inp)

        def collisions(region):
            return self.game.world.get_collisions_w(region, self.game.voxels)

        p.update(mv, collisions)

    def update_game(self):
        """Window recenter + chunk requests (main.rs:268-276)."""
        if not self.freeze_world_anchor:
            anchor = np.floor_divide(
                self.game.player.pos.astype(np.int64), CHUNK_SIZE
            )
            self.game.center_chunks(anchor)
        self.game.request_missing_chunks()

    def world_slice(self):
        """The client pool as a :class:`WorldSlice` on the engine's device;
        the spans that arrived or were edited since the last call are
        copied into the device mirror in place."""
        w = self.game.world
        dev = self.device
        if self._dev_nodes.numel() != len(w.nodes):  # the pool grew
            self._dev_nodes = torch.tensor(w.nodes, device=dev)
            self._dirty_spans.clear()
        for start, n in self._dirty_spans:
            self._dev_nodes[start:start + n] = torch.from_numpy(
                w.nodes[start:start + n]).to(dev)
        self._dirty_spans.clear()
        return WorldSlice(
            nodes=self._dev_nodes,
            chunk_roots=torch.from_numpy(
                np.asarray(w.chunk_roots(), np.int32)).to(dev),
            world_min=torch.tensor(np.asarray(w.min_voxel, np.int32),
                                   device=dev),
        )

    def camera(self):
        p = self.game.player
        return CamData.create(
            rot_deg=tuple(p.rot),
            eye=tuple(p.cam_pos),
            fov_deg=p.fov,
            proj_size=self.resolution,
        )

    def set_resolution(self, width, height):
        """Live render-resolution change (the reference's window-resize /
        result-texture recreation, main.rs:540-556 + graphics/mod.rs
        resize_result_texture). The warm token is size-keyed and resets
        itself."""
        width, height = int(width), int(height)
        assert width % 16 == 0 and height % 8 == 0, (width, height)
        self.resolution = (width, height)

    def draw_frame(self):
        """Render one frame; returns ``f32[H, W, 3]`` on the engine's
        device (main.rs:398-609).

        The crosshair is composited blit-stage, as the reference's screen
        shader does (screen_shader.wgsl:43-65); style comes from the UI's
        Visuals page state when attached (ui.rs crosshair editor).

        With ``fps_cap`` set, calls arriving before 1/cap seconds have
        elapsed return the previous frame without re-rendering — the
        reference's redraw skip (main.rs:682-690).
        """
        if self.fps_cap:
            now = time.monotonic()
            if (
                self._last_img is not None
                and now - self._last_draw_t < 1.0 / float(self.fps_cap)
            ):
                return self._last_img
            self._last_draw_t = now
        if self.fast_path and not self._fast_path_suspended:
            img, rs = self._draw_fast()
        else:
            img, rs = self.tracer.render(
                self.world_slice(), self.camera(), self.settings
            )
        ch = self.crosshair
        if ch is not None and ch.style != "off":
            img = composite_crosshair(
                img, style=ch.style, size=ch.size, color=ch.color
            )
        self.timers.tick()
        self._last_trace = rs
        self._last_img = img
        return img

    # ------------------------------------------------------------ interaction

    def cycle_placing_voxel(self, delta):
        """Scroll-wheel palette: step ``placing_voxel`` through the solid
        voxel ids (main.rs scroll handling, ~:330-340). ``delta``: signed
        wheel notches."""
        solids = [
            vid for vid in range(1, len(self.game.voxels))
            if (vd := self.game.voxels.get(vid)) is not None and vd.is_solid
        ]
        if not solids:
            return self.placing_voxel
        cur = (
            solids.index(self.placing_voxel)
            if self.placing_voxel in solids else 0
        )
        self.placing_voxel = solids[(cur + int(delta)) % len(solids)]
        return self.placing_voxel

    def apply_input_state(self, inp, t_delta=1.0):
        """Drive one input frame from an :class:`~.input.InputState`:
        scroll -> palette, clicks -> break/place, keys/cursor -> player
        physics (the reference's update_input, main.rs:299-396). Clears
        the per-frame edges afterwards."""
        if inp.scroll_delta:
            self.cycle_placing_voxel(
                1 if inp.scroll_delta > 0 else -1
            )
        if inp.button_pressed("left"):
            self.break_voxel()
        if inp.button_pressed("right"):
            self.place_voxel()
        if inp.key_pressed("f2"):
            self.toggle_step_heatmap()
        if inp.key_pressed("f9"):
            self.freeze_world_anchor = not self.freeze_world_anchor
        self.update_input(inp.to_player_input(), t_delta)
        inp.finish_frame()

    def pick(self):
        """Voxel the player is looking at -> (pos, face) or None
        (main.rs:320-325, common DDA picking)."""
        p = self.game.player

        def solid(v):
            try:
                vid = self.game.world.get_voxel(v)
            except (NoChunk, PosOutOfBounds):
                return False
            data = self.game.voxels.get(vid)
            return data is not None and data.is_solid

        return cast_ray(p.cam_pos, p.facing(), PICK_DISTANCE, solid)

    def break_voxel(self):
        hit = self.pick()
        if hit is None:
            return False
        self._edit(hit[0], 0)
        return True

    def place_voxel(self, voxel=None):
        hit = self.pick()
        if hit is None:
            return False
        pos, face = hit
        self._edit(pos + face, voxel if voxel is not None else self.placing_voxel)
        return True

    def _draw_fast(self):
        """One frame over the incremental RenderGrid3: the fused v4 frame
        (``march_fused4``: trace, shadow leg and shade in one launch) or
        the v3 frame. The image and the trace stay on the device."""
        b = self._fast_builder()
        rg = b.grid()
        s = self.settings
        if self.fast_tracer == "v4":
            from ..ops.wavefront4 import render_frame4

            # the packed tables, maintained incrementally by the builder:
            # a world change repacks only its dirty rows
            prepared = b.prepared()
            # the token's shape depends on resolution, shadow legs, and
            # the builder's dense/sparse mode (sparse tokens carry 3 rows)
            key = self.resolution + (bool(s.shadows), b.w, b.sparse)
            cache = self._v4_cache if self._v4_cache_key == key else None
            packed, fl, tok = render_frame4(
                rg, self.camera(), self.materials.color,
                sky_color=s.sky_color, sun_pos=s.sun_pos,
                sun_intensity=s.sun_intensity, shadows=s.shadows,
                shadow_ambient=s.shadow_ambient,
                show_steps=s.show_step_count, with_flags=True,
                fused=True,   # one launch/frame; shadow leg in-kernel
                prepared=prepared,
                cache=cache, return_cache=True,
            )
            self._v4_cache, self._v4_cache_key = tok, key
        else:
            from ..ops.wavefront3 import render_frame3

            packed, fl = render_frame3(
                rg, self.camera(), self.materials.color,
                sky_color=s.sky_color, sun_pos=s.sun_pos,
                sun_intensity=s.sun_intensity, shadows=s.shadows,
                shadow_ambient=s.shadow_ambient,
                show_steps=s.show_step_count, with_flags=True,
            )
        img = (
            torch.stack(
                [(packed >> sh) & 0xFF for sh in (0, 8, 16)], dim=-1
            ).to(torch.float32)
            / _f32(255.0, packed.device)
        )
        rs = SimpleNamespace(
            hit=((fl >> 1) & 1) != 0,
            voxel=(fl >> 17) & 0xFF,
            steps=(fl >> 5) & 0xFFF,
            packed=packed,
        )
        return img, rs

    def _edit(self, pos, voxel):
        chunk = self.game.set_voxel(pos, voxel)
        if chunk is not None:
            used = chunk.alloc.last_used_addr + 1
            self._dirty_spans.append((chunk.start, used))
            if self.fast_path and self._rg_builder is not None:
                cpos = np.floor_divide(np.asarray(pos, np.int64), CHUNK_SIZE)
                self._fast_set_chunks([cpos])

    # ------------------------------------------------------------ debug

    def toggle_step_heatmap(self):
        """F2 analog (main.rs:368-370): render DDA iteration counts."""
        from dataclasses import replace

        self.settings = replace(
            self.settings, show_step_count=not self.settings.show_step_count
        )
        self.tracer = RayTracer(
            self.materials, show_step_count=self.settings.show_step_count,
            shadows=self.tracer.shadows,
        )

    def resize_world(self, size_in_chunks):
        """Live window resize, 10..80 (ui.rs:163-168). The fused path
        covers the full reference slider range: dense packed tables to
        32 chunks, SPARSE tables beyond (world/render_grid.py)."""
        size_in_chunks = max(2, min(80, int(size_in_chunks)))
        self.game.world.resize(size_in_chunks)
        if self.fast_path and size_in_chunks > FAST_PATH_MAX_W:
            _log.warning(
                "window %d > %d chunks exceeds the fused path's table "
                "budget; rendering falls back to the SVO tracer",
                size_in_chunks, FAST_PATH_MAX_W,
            )
            self._fast_path_suspended = True
        elif self._fast_path_suspended and size_in_chunks <= FAST_PATH_MAX_W:
            self._fast_path_suspended = False
        self.game.request_missing_chunks()

    def debug_overlay(self):
        """The egui overlay panel as data (ui.rs:105-178)."""
        w = self.game.world
        free, total = w.node_space_status()
        p = self.game.player
        return {
            "fps": self.timers.fps,
            "placing_voxel": self.placing_voxel,
            "player_pos": tuple(float(v) for v in p.pos),
            "on_ground": p.on_ground,
            "flying": p.flying,
            "world_size_chunks": w.size_in_chunks,
            "chunks_populated": w.populated_count(),
            "chunks_total": w.size_in_chunks**3,
            "node_space_used_frac": 1.0 - free / total,
        }

    # ------------------------------------------------------------ teardown

    def close(self):
        self.game.disconnect()
        if self.server_program is not None:
            self.server_program.shutdown()
