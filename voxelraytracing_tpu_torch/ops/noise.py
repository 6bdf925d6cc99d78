"""Seeded gradient noise on the host (NumPy).

Port of ``voxelraytracing_tpu/ops/noise.py``: the permutation table, the
``transmute_seed`` chain of the reference (server/src/world/gen.rs:48-55)
and the NumPy Perlin sampler that the demo world builder uses. The
device sampler stays in the JAX package until the worldgen slice; the
host twin is all the primary frame needs.

Everything evaluates in float32, like the JAX module.
"""

import numpy as np

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
