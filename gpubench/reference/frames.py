"""The reference's frames: the raster frame (camera rays marched once and
shaded to RGBA8) and the path-traced frame (radiance over a camera leg and
its bounce legs), in plain PyTorch on the reference scene
(:mod:`.march`). Written from the semantics the configurations state:

* camera rays unproject pixel ``(px, py)`` (its corner) at clip
  ``(2 px / W - 1, -(2 py / H - 1), -1, 1)`` through the inverse
  projection and view matrices as row vectors; only pixels of whole 16x8
  tiles trace, and only from a camera strictly inside the world;
* the raster shade: the hit voxel's colour tinted by the face crossed
  (x faces 0.5, z faces 0.7, faces seen from below 0.2), else the sky
  (a horizon gradient and the sun's disc), then the water overlay, each
  channel truncated to a byte;
* the path tracer: at each leg's end, Beer-Lambert absorption along the
  leg's water, the sky for rays that missed, emission and albedo for rays
  that hit; a hit ray scatters about the face normal (a Box-Muller sample
  of a murmur3 counter hash of its tiled ray id, mixed with the mirror
  direction by the material's scatter) from its hit point snapped to the
  face and nudged off it.

Nothing here reads the program's tables or state; ``dtype`` is the float
type every float operation runs in.
"""

import math

import numpy as np
import torch

from . import prng
from .march import march

TILE_W, TILE_H = 16, 8
WATER_ABSORB = (0.35, 0.08, 0.04)  # per voxel of water, r g b
WATER_TINT = (0.2, 0.5, 1.0)
NUDGE = 4e-3                     # a bounce origin's offset off its face
M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def camera_rays(cam, world_min, dtype, device):
    """Origins (3 flat tensors) and unit directions of every pixel of
    ``cam`` (``pos``, ``inv_view``, ``inv_proj``, ``proj_size``), world-local;
    the pixels that trace (whole tiles, camera strictly inside ``v``) are
    found by :func:`traced`."""
    w, h = cam.proj_size
    f = dict(dtype=dtype, device=device)
    py, px = torch.meshgrid(torch.arange(h, **f), torch.arange(w, **f),
                            indexing="ij")
    x = (px.reshape(-1) * 2.0) / w - 1.0
    y = (py.reshape(-1) * 2.0) / h - 1.0
    ip = torch.as_tensor(np.asarray(cam.inv_proj, np.float32)).to(**f)
    iv = torch.as_tensor(np.asarray(cam.inv_view, np.float32)).to(**f)
    clip = (x, -y, -torch.ones_like(x), torch.ones_like(x))
    eye = [sum(clip[i] * ip[i, j] for i in range(4)) for j in range(2)]
    e4 = (eye[0], eye[1], -torch.ones_like(x))          # w = 0: a direction
    d = [sum(e4[i] * iv[i, j] for i in range(3)) for j in range(3)]
    n = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    d = [c / n for c in d]
    origin = (np.asarray(cam.pos, np.float64) - np.asarray(world_min, np.float64))
    o = [torch.full_like(x, float(c)) for c in origin]
    return o, d


def traced(cam, world_min, v, device):
    """bool per pixel: in a whole 16x8 tile, camera strictly inside [0, v)^3."""
    w, h = cam.proj_size
    py, px = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    whole = ((px // TILE_W) < w // TILE_W) & ((py // TILE_H) < h // TILE_H)
    local = np.asarray(cam.pos, np.float64) - np.asarray(world_min, np.float64)
    return whole.reshape(-1) & all(0.0 < float(c) < v for c in local)


def _smooth(e0, e1, x):
    q = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return q * q * (3.0 - 2.0 * q)


def _sky(dy, sun, sky_color):
    """Sky radiance channels from a ray's height ``dy`` and its sun term."""
    gts = _smooth(-0.01, 0.0, dy)
    grad = torch.pow(_smooth(0.0, 0.4, dy), 0.35)
    out = []
    for horizon, c in zip((1.0, 0.3, 0.0), sky_color):
        g = horizon + (float(np.float32(c)) - horizon) * grad
        out.append(0.03 + (g - 0.03) * gts + sun)
    return out, gts


class Work:
    """The work the reference's legs found: steps, rays marched, and the
    distinct subwindow rows and windows each leg read (summed over legs,
    and the largest of one leg)."""

    def __init__(self):
        self.steps = self.rays = self.rows = self.windows = 0
        self.legs = []

    def add(self, leg, pixels):
        self.steps += leg.n_steps
        self.rays += leg.n_rays
        self.rows += leg.rows
        self.windows += leg.windows
        self.legs.append(dict(steps=leg.n_steps, rays=leg.n_rays,
                              rows=leg.rows, windows=leg.windows,
                              pixels=pixels))


def raster_frame(scene, cam, world_min, *, step_cap, sky_color, sun_pos,
                 sun_intensity, colors, dtype=torch.float32):
    """The raster frame: uint8 [H, W, 4] RGBA and the :class:`Work`."""
    dev = scene.ids.device
    w, h = cam.proj_size
    o, d = camera_rays(cam, world_min, dtype, dev)
    leg = march(scene, o, d, traced(cam, world_min, scene.v, dev), step_cap)
    work = Work()
    work.add(leg, w * h)
    col = torch.as_tensor(np.asarray(colors, np.float32)).to(dtype=dtype, device=dev)
    tint = torch.where((leg.axm & 1) != 0, 0.5, 1.0)
    tint = tint * torch.where((leg.axm & 4) != 0, 0.7, 1.0)
    tint = tint * torch.where(((leg.axm & 2) != 0) & (d[1] > 0), 0.2, 1.0)
    base = col[leg.vox.long()] * tint.to(dtype)[:, None]
    sv = np.asarray(sun_pos, np.float64) - np.asarray(cam.pos, np.float64)
    sv = sv / math.sqrt(float(sv @ sv))
    sky, gts = _sky(d[1], 0.0, sky_color)
    sun = ((d[0] * float(sv[0]) + d[1] * float(sv[1]) + d[2] * float(sv[2]) > 0.99)
           & (gts >= 1.0)).to(dtype) * sun_intensity
    chans = []
    for c in range(3):
        x = torch.where(leg.hit, base[:, c], sky[c] + sun)
        f = torch.clamp(leg.water / 14.0, 0.8, 1.0)
        x = torch.where(leg.water != 0, x * (1.0 - f) + WATER_TINT[c] * f, x)
        chans.append(torch.nan_to_num(torch.clamp(x, 0.0, 1.0) * 255.0)
                     .to(torch.int32).to(torch.uint8))
    alpha = torch.full_like(chans[0], 255)
    return torch.stack(chans + [alpha], dim=-1).reshape(h, w, 4), work


def ray_ids(width, height, device):
    """The id each pixel's draws key on: ``tile * 128 + lane`` with tiles of
    16x8 pixels ordered in superblocks of 8x8 tiles, superblock-major."""
    py, px = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    nsx = -(-(width // TILE_W) // 8)
    tx, ty = px // TILE_W, py // TILE_H
    tile = ((ty // 8) * nsx + tx // 8) * 64 + (ty % 8) * 8 + tx % 8
    return tile * 128 + (py % TILE_H) * TILE_W + px % TILE_W


def unit_draws(rid, base, count, dtype):
    """``count`` draws in (0, 1) per ray: the murmur3 finalizer of ``rid ^
    base ^ j * 0x632BE5AB``, its top 23 bits as a fraction, offset by half
    a step (32-bit words held in int64)."""
    out = []
    for j in range(count):
        h = rid ^ ((base ^ (j * 0x632BE5AB)) & M32)
        h = h ^ (h >> 16)
        h = (h * 0x85EBCA6B) & M32
        h = h ^ (h >> 13)
        h = (h * 0xC2B2AE35) & M32
        h = h ^ (h >> 16)
        out.append((h >> 9).to(dtype) * (1.0 / (1 << 23)) + (1.0 / (1 << 24)))
    return out


def key_bases(key, bounces, draws):
    """The hash base of each scatter (after legs 0 .. bounces-1) of one
    sample path, from the frame's raw key words: ``"threefry"`` folds the
    scatter's index into the sample's key (``split(key, 1)[0]``), ``"seed"``
    mixes the key words with the bounces left."""
    if draws == "threefry":
        skey = prng.split(key, 1)[0]
        out = []
        for b in range(bounces):
            kd = prng.fold_in(skey, b)
            out.append(int(kd[0]) ^ ((int(kd[1]) * GOLDEN) & M32))
        return out
    if draws == "seed":
        k = prng.key_data(key)
        base = int(k[0]) ^ ((int(k[1]) * GOLDEN) & M32)   # sample 0
        return [base ^ (((bounces - b) * GOLDEN) & M32) for b in range(bounces)]
    raise ValueError(f"unknown draws {draws!r}")


def _scatter(o, d, t, axm, scat, rid, base, dtype):
    """The next ray of each path from its leg's end."""
    bits = [((axm >> i) & 1) != 0 for i in range(3)]
    n = [torch.where(b, -torch.sign(c), 0.0).to(dtype) for c, b in zip(d, bits)]
    none = ~(bits[0] | bits[1] | bits[2])
    n = [torch.where(none, -c, nc) for c, nc in zip(d, n)]
    u1, u2, u3, u4 = unit_draws(rid, base, 4, dtype)
    r1 = torch.sqrt(-2.0 * torch.log(u1))
    r2 = torch.sqrt(-2.0 * torch.log(u3))
    a1, a2 = u2 * (2.0 * math.pi), u4 * (2.0 * math.pi)
    g = [r1 * torch.cos(a1), r1 * torch.sin(a1), r2 * torch.cos(a2)]

    def unit(vec, fallback):
        ln = torch.sqrt(vec[0] * vec[0] + vec[1] * vec[1] + vec[2] * vec[2])
        return [torch.where(ln > 1e-6, c / torch.clamp_min(ln, 1e-6), f)
                for c, f in zip(vec, fallback)]

    gl = torch.clamp_min(torch.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]), 1e-6)
    diffuse = unit([nc + gc / gl for nc, gc in zip(n, g)], n)
    dn = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
    mirror = [c - 2.0 * dn * nc for c, nc in zip(d, n)]
    nd = unit([a * scat + b * (1.0 - scat) for a, b in zip(diffuse, mirror)], n)
    p = [oc + dc * t for oc, dc in zip(o, d)]
    p = [torch.where(b, torch.floor(pc + 0.5), pc) for pc, b in zip(p, bits)]
    return [pc + nc * NUDGE for pc, nc in zip(p, n)], nd


def path_frame(scene, cam, world_min, *, step_cap, bounces, key, draws,
               sky_color, sun_pos, sun_intensity, materials,
               dtype=torch.float32):
    """The path-traced frame (one sample a pixel): float [H, W, 3] radiance
    and the :class:`Work`. ``materials``: colour [V, 3], emission [V],
    scatter [V] per pack id; ``key``: the frame's raw key words."""
    dev = scene.ids.device
    w, h = cam.proj_size
    f = dict(dtype=dtype, device=dev)
    col = torch.as_tensor(np.asarray(materials.color, np.float32)).to(**f)
    emis = torch.as_tensor(np.asarray(materials.emission, np.float32)).to(**f)
    scat = torch.as_tensor(np.asarray(materials.scatter, np.float32)).to(**f)
    sun = [float(s) - float(m) for s, m in zip(sun_pos, world_min)]
    o, d = camera_rays(cam, world_min, dtype, dev)
    rid = ray_ids(w, h, dev)
    bases = key_bases(key, bounces, draws)
    live = torch.ones(w * h, dtype=torch.bool, device=dev)
    active = traced(cam, world_min, scene.v, dev)
    thr = [torch.ones(w * h, **f) for _ in range(3)]
    rad = [torch.zeros(w * h, **f) for _ in range(3)]
    work = Work()
    for b in range(bounces + 1):
        leg = march(scene, o, d, active & live, step_cap)
        work.add(leg, w * h)
        thr = [torch.where(live, c * torch.exp(-leg.water * k), c)
               for c, k in zip(thr, WATER_ABSORB)]
        # the sky with the sun's disc seen from each ray's origin
        sv = [s - oc for s, oc in zip(sun, o)]
        sn = torch.sqrt(sv[0] * sv[0] + sv[1] * sv[1] + sv[2] * sv[2])
        cos_sun = (d[0] * sv[0] + d[1] * sv[1] + d[2] * sv[2]) / sn
        _, gts = _sky(d[1], 0.0, sky_color)
        sun_term = ((cos_sun > 0.99) & (gts >= 1.0)).to(dtype) * sun_intensity
        sky, _ = _sky(d[1], sun_term, sky_color)
        miss = live & ~leg.hit
        got = live & leg.hit
        vox = leg.vox.long()
        for c in range(3):
            rad[c] = rad[c] + torch.where(miss, thr[c] * sky[c], 0.0)
            rad[c] = rad[c] + torch.where(got, thr[c] * emis[vox] * col[vox, c], 0.0)
            thr[c] = torch.where(got, thr[c] * col[vox, c], thr[c])
        live = got
        if b == bounces:
            break
        o, d = _scatter(o, d, leg.t, leg.axm, scat[vox], rid, bases[b], dtype)
    return torch.stack(rad, dim=-1).reshape(h, w, 3), work
