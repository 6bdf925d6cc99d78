"""The client's frame: the engine's ``_draw_fast`` on its streaming builder
(``RenderGrid3Builder``, the window installed in the engine's 512-chunk
batches), ``render_frame4(fused=True, prepared=builder.prepared())`` with
the warm token handed from frame to frame. The frame is the packed RGBA8
image."""

import time

from voxelraytracing_tpu_torch.ops import wavefront4
from voxelraytracing_tpu_torch.world.render_grid import RenderGrid3Builder

REFERENCE = "raster"
INSTALL_BATCH = 512   # chunks an engine install takes (engine/app.py)


class State:
    def __init__(self, builder, cfg, sun, colors):
        self.builder, self.cfg, self.sun, self.colors = builder, cfg, sun, colors
        self.token = None
        self.spans = {}


def setup(world, cfg, frames, device):
    t0 = time.perf_counter()
    b = RenderGrid3Builder(world.w, world.materials, world_min=world.world_min,
                           device=device)
    cells = world.cells()
    for lo in range(0, len(cells), INSTALL_BATCH):
        b.set_chunks([tuple(int(a) for a in c) for c in cells[lo:lo + INSTALL_BATCH]],
                     world.chunks[lo:lo + INSTALL_BATCH])
    b.grid()
    b.prepared()
    state = State(b, cfg, frames.sun, world.materials.color)
    state.spans["world_build_s"] = time.perf_counter() - t0
    return state


def frame(state, cam, key):
    b, cfg = state.builder, state.cfg
    img, state.token = wavefront4.render_frame4(
        b.grid(), cam, state.colors, sky_color=tuple(cfg["sky_color"]),
        sun_pos=state.sun, sun_intensity=cfg["sun_intensity"], shadows=False,
        step_cap=cfg["step_cap"], fused=True, prepared=b.prepared(),
        cache=state.token, return_cache=True)
    return img


def free(state):
    state.builder = None
