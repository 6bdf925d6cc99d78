"""config5's frame through the one-launch path tracer:
``path_trace_fused4`` with the prepared dense tables; one ``pt4`` launch
walks every path. The frame is the radiance image."""

from voxelraytracing_tpu_torch.ops import pathtrace4

from .pathtrace_v4 import State, free, tables  # noqa: F401  (free: the same)

REFERENCE = "path"
DRAWS = "seed"   # a scatter's draws key on the key words and the bounces left


def setup(world, cfg, frames, device):
    rg, prep = tables(world, device)
    return State(rg, prep, cfg, frames.sun, world.materials)


def frame(state, cam, key):
    cfg = state.cfg
    return pathtrace4.path_trace_fused4(
        state.rg, cam, state.materials, prepared=state.prep,
        bounces=cfg["bounces"], samples=cfg["samples"],
        step_cap=cfg["step_cap"], key=key, sun_pos=state.sun,
        sky_color=tuple(cfg["sky_color"]), sun_intensity=cfg["sun_intensity"])
