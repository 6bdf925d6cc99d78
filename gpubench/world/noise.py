# Frozen copy of voxelraytracing_tpu_torch/ops/noise.py at commit 5046bbb1c27cf55a0e0985dd2724f80b90766057
# (the benchmark's yardstick: later changes to the program do not reach it).
# Copied unchanged.

"""Seeded gradient noise: the device sampler and its NumPy twin.

Port of ``voxelraytracing_tpu/ops/noise.py``: the permutation table, the
``transmute_seed`` chain of the reference (server/src/world/gen.rs:48-55),
the Perlin sampler on torch tensors (``perlin2d``, ``sample01``, ``Map``,
``MappedNoise``, ``RawNoise``; the worldgen's and the demo builder's) and
its NumPy twin (the host demo builder's).

Everything evaluates in float32, like the JAX module. The device sampler
is ``floor``, multiplies and adds only, each a torch op of its own in the
JAX op order, so it rounds alike on the card and on the CPU, and as JAX's
sampler evaluated op by op.
"""

from dataclasses import dataclass

import numpy as np
import torch

_I64_MIN, _I64_RANGE = -(2**63), 2**64


def _wrap_i64(x):
    return (x - _I64_MIN) % _I64_RANGE + _I64_MIN


def transmute_seed(seed):
    """Advance-and-mix the running world seed; returns (new_seed, derived).

    Wrapping i64 arithmetic identical to the reference chain
    (server/src/world/gen.rs:48-55).
    """
    seed = _wrap_i64(seed + 890189034)
    seed = _wrap_i64(seed * 917834)
    seed = _wrap_i64(seed << 1)
    seed = _wrap_i64(seed + 6478912)
    seed = _wrap_i64(seed * 891247)
    return seed, seed


def _splitmix64(state):
    state = (state + 0x9E3779B97F4A7C15) % 2**64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % 2**64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2**64
    return state, z ^ (z >> 31)


def make_permutation(seed):
    """256-entry permutation (doubled to 512 for wrap-free lookups).

    Seeded by the low 32 bits of the i64 field seed, mirroring the
    reference's ``PermutationTable::new(seed as u32)``
    (common/src/world/noise.rs:27-31).
    """
    state = int(seed) & 0xFFFFFFFF
    perm = np.arange(256, dtype=np.int32)
    for i in range(255, 0, -1):
        state, r = _splitmix64(state)
        j = r % (i + 1)
        perm[i], perm[j] = perm[j], perm[i]
    return np.concatenate([perm, perm]).astype(np.int32)


# 2-D gradient set: the four diagonals, as in classic Perlin / the noise crate.
_GRADS = np.array([[1.0, 1.0], [-1.0, 1.0], [1.0, -1.0], [-1.0, -1.0]], dtype=np.float32)
# Normalizes the diagonal-gradient output into [-1, 1].
_SCALE = np.float32(2.0 / np.sqrt(2.0))


def perlin2d(perm, pos):
    """Raw 2-D Perlin noise in [-1, 1].

    Args:
      perm: ``[512]`` doubled permutation from :func:`make_permutation`
        (array or tensor).
      pos: ``f32[..., 2]`` sample positions (a tensor: the sampler runs on
        its device).
    Returns:
      ``f32[...]``.
    """
    pos = torch.as_tensor(pos, dtype=torch.float32)
    perm = torch.as_tensor(perm, device=pos.device).long()
    p0 = torch.floor(pos)
    frac = pos - p0
    xi = p0[..., 0].to(torch.int32).long() & 255
    yi = p0[..., 1].to(torch.int32).long() & 255
    fx, fy = frac[..., 0], frac[..., 1]

    def corner_dot(dx, dy):
        h = perm[perm[xi + dx] + yi + dy] & 3
        # the gradient's components are +-1: gx = 1 for h in {0, 2}, gy =
        # 1 for h in {0, 1} (_GRADS), so g * d is exact and the sum is the
        # one rounding of JAX's two-term sum
        gx = torch.where((h & 1) == 0, 1.0, -1.0)
        gy = torch.where(h < 2, 1.0, -1.0)
        return gx * (fx - float(dx)) + gy * (fy - float(dy))

    n00 = corner_dot(0, 0)
    n10 = corner_dot(1, 0)
    n01 = corner_dot(0, 1)
    n11 = corner_dot(1, 1)

    # quintic fade
    t = frac * frac * frac * (frac * (frac * 6.0 - 15.0) + 10.0)
    u, v = t[..., 0], t[..., 1]
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    val = (nx0 + v * (nx1 - nx0)) * float(_SCALE)
    return torch.clamp(val, -1.0, 1.0)


def sample01(perm, pos):
    """Perlin mapped into [0, 1] (reference: noise.rs:34-38)."""
    return torch.clamp((perlin2d(perm, pos) + 1.0) * 0.5, 0.0, 1.0)


@dataclass(frozen=True)
class Map:
    """freq/scale/offset transform (reference: noise.rs:6-20)."""

    freq: float
    scale: float
    offset: float


@dataclass(frozen=True)
class MappedNoise:
    """A permutation table plus a Map (reference: noise.rs:45-62)."""

    perm: np.ndarray
    map: Map

    @classmethod
    def from_seed(cls, seed, m):
        return cls(perm=make_permutation(seed), map=m)

    def sample(self, pos):
        """sample01(pos * freq) * scale + offset on ``pos``'s device."""
        pos = torch.as_tensor(pos, dtype=torch.float32)
        return (sample01(self.perm, pos * self.map.freq) * self.map.scale
                + self.map.offset)


@dataclass(frozen=True)
class RawNoise:
    perm: np.ndarray

    @classmethod
    def from_seed(cls, seed):
        return cls(perm=make_permutation(seed))

    def sample(self, pos):
        pos = torch.as_tensor(pos, dtype=torch.float32)
        return sample01(self.perm, pos)

    def map_sample(self, pos, m):
        pos = torch.as_tensor(pos, dtype=torch.float32)
        return self.sample(pos * m.freq) * m.scale + m.offset


def perlin2d_np(perm, pos):
    """Raw 2-D Perlin noise in [-1, 1]: ``f32[..., 2]`` -> ``f32[...]``."""
    pos = np.asarray(pos, dtype=np.float32)
    p0 = np.floor(pos)
    frac = (pos - p0).astype(np.float32)
    xi = p0[..., 0].astype(np.int64) & 255
    yi = p0[..., 1].astype(np.int64) & 255
    perm = np.asarray(perm)

    def corner_dot(dx, dy):
        h = perm[perm[xi + dx] + yi + dy] & 3
        g = _GRADS[h]
        d = frac - np.asarray([dx, dy], dtype=np.float32)
        return np.sum(g * d, axis=-1)

    n00 = corner_dot(0, 0)
    n10 = corner_dot(1, 0)
    n01 = corner_dot(0, 1)
    n11 = corner_dot(1, 1)
    t = frac * frac * frac * (frac * (frac * 6.0 - 15.0) + 10.0)
    u, v = t[..., 0], t[..., 1]
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    val = (nx0 + v * (nx1 - nx0)) * _SCALE
    return np.clip(val, -1.0, 1.0)


def sample01_np(perm, pos):
    """Perlin mapped into [0, 1] (reference: noise.rs:34-38)."""
    return np.clip((perlin2d_np(perm, pos) + 1.0) * 0.5, 0.0, 1.0)
