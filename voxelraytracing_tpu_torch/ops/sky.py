"""Procedural sky: horizon/void gradient plus a sun disc.

Port of ``voxelraytracing_tpu/ops/sky.py`` (the reference sky model,
ray_tracer.wgsl:144-157): a smoothstep blend from a void color below the
horizon through a horizon gradient into the sky color, and a hard sun disc
where the ray direction is within ``1 - 0.01`` of the sun direction above
the horizon. Runs in torch on the device of ``dirs``.
"""

import torch

from .camera import _f32, sqrt_rn

HORIZON_COLOR = (1.0, 0.3, 0.0)
VOID_COLOR = (0.03, 0.03, 0.03)
SUN_SIZE = 0.01


def smoothstep(e0, e1, x):
    """``t*t*(3 - 2t)`` of ``t = clip((x - e0) / (e1 - e0), 0, 1)``; the
    division is by a device scalar, IEEE on CUDA too."""
    t = torch.clamp((x - e0) / _f32(e1 - e0, x.device), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def ray_sky(dirs, origin, sky_color, sun_pos, sun_intensity, world_min):
    """Sky radiance f32[..., 3] for rays ``dirs`` (f32[..., 3]) from the
    world-local ``origin`` (f32[3], or one a ray: f32[..., 3]).

    ``sun_pos`` is a world-coordinate position; the sun direction is
    ``normalize(sun_pos - world_min - origin)`` (ray_tracer.wgsl:152).
    """
    dev = dirs.device

    def vec(x):
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    y = dirs[..., 1]
    ground_to_sky = smoothstep(-0.01, 0.0, y)
    gradient_t = smoothstep(0.0, 0.4, y) ** 0.35
    horizon = vec(HORIZON_COLOR)
    void = vec(VOID_COLOR)
    gradient = horizon + (vec(sky_color) - horizon) * gradient_t[..., None]

    sun_vec = vec(sun_pos) - vec(world_min) - vec(origin)
    sq = sun_vec * sun_vec
    sun_dir = sun_vec / sqrt_rn(((sq[..., 0] + sq[..., 1]) + sq[..., 2])[..., None])
    dot = (dirs[..., 0] * sun_dir[..., 0] + dirs[..., 1] * sun_dir[..., 1]) \
        + dirs[..., 2] * sun_dir[..., 2]
    sun = ((dot > (1.0 - SUN_SIZE)) & (ground_to_sky >= 1.0)).to(torch.float32)

    base = void + (gradient - void) * ground_to_sky[..., None]
    return base + (sun * vec(sun_intensity))[..., None]
