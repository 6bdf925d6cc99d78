"""config5's route (benchmarks/run.py:800-805): ``path_trace3(v4=True)``
with the prepared dense tables and the warm token handed from frame to
frame; every leg is a ``march_planes4`` launch, the leg ends are torch ops.
The frame is the radiance image."""

from voxelraytracing_tpu_torch.ops import pathtrace3, wavefront3, wavefront4

REFERENCE = "path"
DRAWS = "threefry"   # a scatter's draws key on fold_in(split(key)[0], bounce)


class State:
    def __init__(self, rg, prep, cfg, sun, materials):
        self.rg, self.prep, self.cfg, self.sun = rg, prep, cfg, sun
        self.materials = materials
        self.token = None
        self.spans = {}


def tables(world, device):
    """The frame tables of the window (``build_render_grid3_host`` on its
    grids, ``prepare_grid4``)."""
    c = world.cells()
    w = world.w
    cells = c[:, 0] + c[:, 1] * w + c[:, 2] * w * w
    rg = wavefront3.build_render_grid3_host(world.chunks, cells, world.world_min,
                                            w, world.materials, device=device)
    return rg, wavefront4.prepare_grid4(rg)


def setup(world, cfg, frames, device):
    rg, prep = tables(world, device)
    return State(rg, prep, cfg, frames.sun, world.materials)


def frame(state, cam, key):
    cfg = state.cfg
    img, state.token = pathtrace3.path_trace3(
        state.rg, cam, state.materials, v4=True, prepared=state.prep,
        cache=state.token, return_cache=True, bounces=cfg["bounces"],
        samples=cfg["samples"], step_cap=cfg["step_cap"], key=key,
        sun_pos=state.sun, sky_color=tuple(cfg["sky_color"]),
        sun_intensity=cfg["sun_intensity"])
    return img


def free(state):
    state.rg = state.prep = None
