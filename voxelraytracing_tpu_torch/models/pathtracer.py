"""Progressive path tracer over the SVO node pool.

Port of ``voxelraytracing_tpu/models/pathtracer.py``: a **wavefront**
bounce loop — a fixed number of whole-frame :func:`~..ops.traverse.
trace_rays` passes with structure-of-arrays ray state — with
counter-based keys per (sample, bounce), so accumulation is deterministic
and order-independent. It runs in torch on the device of the world's
tensors.

Per bounce (semantics of path_tracer.wgsl:149-194, completed):
  * trace all active rays; on hit: ``incoming += emission * color_so_far``,
    ``color_so_far *= albedo``; next direction mixes the specular reflection
    with a cosine-weighted scatter by the material's ``scatter`` factor.
  * on miss: ``incoming += sky * color_so_far`` and the ray retires.
  * liquid path segments attenuate by Beer–Lambert absorption toward the
    material's water tint.

The scatter directions are ``jax.random.normal``'s draws word for word
(``ops/prng.py:normal`` on the raw key data of ``split`` and ``fold_in``),
so a frame differs from JAX's only by the ulps of ``exp`` and of XLA's
contracted multiply-adds.
"""

import numpy as np
import torch

from ..core.constants import MAX_PATH_STEPS, RAY_EPS
from ..ops import prng
from ..ops.camera import _f32, generate_rays_raw, sqrt_rn
from ..ops.sky import ray_sky
from ..ops.traverse import WorldSlice, trace_rays

# per-voxel-length absorption of the water tint
WATER_ABSORB = (0.35, 0.08, 0.04)


def _norm(v):
    """Euclidean length over the last axis, keeping it (``jnp.linalg.norm``
    with ``keepdims``: the squares summed in axis order)."""
    sq = v * v
    return sqrt_rn((sq[..., 0] + sq[..., 1]) + sq[..., 2])[..., None]


def _diffuse_dir(key, norm):
    """Cosine-ish scatter: normalize(norm + random unit vector)
    (path_tracer.wgsl:186-189); ``key`` is raw key data."""
    v = prng.normal(key, tuple(norm.shape), device=norm.device)
    v = v / _norm(v)
    d = norm + v
    # degenerate (v == -norm): fall back to the normal
    n = _norm(d)
    eps = torch.full_like(n, 1e-6)
    return torch.where(n > 1e-6, d / torch.maximum(n, eps), norm)


def _reflect(d, n):
    dn = d * n
    dot = ((dn[..., 0] + dn[..., 1]) + dn[..., 2])[..., None]
    return d - 2.0 * dot * n


class PathTracer:
    """Wavefront path tracer over a WorldSlice."""

    def __init__(self, materials, max_bounces=3, max_steps=MAX_PATH_STEPS):
        self.materials = materials
        self.max_bounces = int(max_bounces)
        self.max_steps = int(max_steps)

    def render(self, world: WorldSlice, cam, settings=None, samples=1,
               key=None):
        """One progressive frame: the mean of ``samples`` paths a pixel,
        ``f32[H, W, 3]`` radiance on the world's device. ``key`` is raw key
        data ``uint32[2]`` (``jax.random.PRNGKey(seed)``'s words; ``None``
        is key 0)."""
        from .raytracer import RenderSettings

        s = settings or RenderSettings()
        w, h = cam.proj_size
        dev = world.nodes.device
        f32 = torch.float32
        mats = self.materials

        def table(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        m_emission, m_color, m_scatter = (
            table(mats.emission), table(mats.color), table(mats.scatter))
        absorb_k = table(WATER_ABSORB)
        wmin = world.world_min.cpu().numpy()
        origin0, dirs0 = generate_rays_raw(cam.inv_view, cam.inv_proj,
                                           cam.pos, w, h, wmin, device=dev)
        shape = dirs0.shape[:-1]
        zero = torch.zeros((), dtype=f32, device=dev)
        one = torch.ones((), dtype=f32, device=dev)

        def one_sample(sample_key):
            origin = origin0.expand(dirs0.shape)
            dirs = dirs0
            color = torch.ones(shape + (3,), dtype=f32, device=dev)
            light = torch.zeros(shape + (3,), dtype=f32, device=dev)
            alive = torch.ones(shape, dtype=torch.bool, device=dev)

            for bounce in range(self.max_bounces + 1):
                rs = trace_rays(world, mats.is_liquid, origin, dirs,
                                self.max_steps)

                # liquid absorption along this segment
                absorb = torch.exp(-rs.water_dist[..., None] * absorb_k)
                color = color * torch.where(alive[..., None], absorb, one)

                # miss -> sky light, retire
                sky = ray_sky(dirs, origin, s.sky_color, s.sun_pos,
                              s.sun_intensity, wmin)
                miss = alive & ~rs.hit
                light = light + torch.where(miss[..., None], color * sky, zero)

                hit = alive & rs.hit
                vox = rs.voxel.long()
                emis = m_emission[vox][..., None]
                albedo = m_color[vox]
                light = light + torch.where(hit[..., None],
                                            color * emis * albedo, zero)
                color = torch.where(hit[..., None], color * albedo, color)
                alive = hit

                if bounce == self.max_bounces:
                    break

                # next ray: offset off the surface, mix diffuse/specular
                bkey = prng.fold_in(sample_key, bounce)
                norm = rs.norm
                # camera-inside-voxel etc.: zero normal -> bounce straight back
                degenerate = (norm == 0.0).all(dim=-1, keepdim=True)
                norm = torch.where(degenerate, -dirs, norm)
                diff = _diffuse_dir(bkey, norm)
                spec = _reflect(dirs, norm)
                scat = m_scatter[vox][..., None]
                nd = diff * scat + spec * (1.0 - scat)
                # guarded normalize: a zero-length mix must not divide by 0
                nn = _norm(nd)
                nd = torch.where(nn > 1e-6,
                                 nd / torch.maximum(nn, torch.full_like(nn, 1e-6)),
                                 norm)
                origin = rs.pos + norm * (4.0 * RAY_EPS)
                dirs = nd

            return light

        keys = prng.split(key, samples)
        acc = torch.zeros(shape + (3,), dtype=f32, device=dev)
        for i in range(samples):
            acc = acc + one_sample(keys[i])
        return acc / _f32(samples, dev)


def accumulate(frames):
    """Temporal accumulation of progressive sample frames."""
    return torch.stack([torch.as_tensor(f) for f in frames]).mean(dim=0)
