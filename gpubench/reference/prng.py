# Frozen copy of voxelraytracing_tpu_torch/ops/prng.py at commit 5046bbb1c27cf55a0e0985dd2724f80b90766057,
# trimmed to the Threefry key functions the reference draws with (threefry2x32,
# key_data, split, fold_in); the first docstring paragraph kept.

"""Threefry-2x32 keys and ``jax.random.normal``'s draws on raw key data.

The path tracers draw their per-ray numbers from an integer counter hash
(murmur3), which the port computes itself. Only the per-sample and
per-bounce key words come from ``jax.random`` in the JAX package:
``split(key, samples)`` (wavefront3.py:3023) and ``fold_in(skey, bounce)``
(:2937), read back with ``key_data`` (:2939-2942). Both are Threefry-2x32
on two uint32 words, so this module reproduces them bit for bit on the
raw ``uint32[2]`` key data that ``jax.random.PRNGKey(seed)`` holds: the
counterpart of ``jax/_src/prng.py`` ``threefry_2x32``,
``_threefry_split_foldlike`` (the ``jax_threefry_partitionable`` path,
the default since JAX 0.5) and ``_threefry_fold_in``.
"""

import numpy as np


_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_M32 = 0xFFFFFFFF


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block (20 rounds) of key ``(k0, k1)`` on the
    counter words ``(x0, x1)`` (uint32 arrays of one shape)."""
    with np.errstate(over="ignore"):
        k0, k1 = np.uint32(k0), np.uint32(k1)
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1




def key_data(key):
    """Raw key data ``uint32[2]``; ``None`` is ``PRNGKey(0)``."""
    if key is None:
        return np.zeros(2, np.uint32)
    kd = np.asarray(key).reshape(-1)
    if kd.shape != (2,) or kd.dtype.kind not in "ui":
        raise ValueError(f"want raw key data uint32[2], got {kd.dtype}{list(kd.shape)}")
    return kd.astype(np.uint32)


def split(key, num=2):
    """``jax.random.split(key, num)`` on raw key data -> ``uint32[num, 2]``:
    key ``i`` is the block of counter ``(0, i)``."""
    k = key_data(key)
    n = np.arange(num, dtype=np.uint64)
    b0, b1 = threefry2x32(k[0], k[1], (n >> np.uint64(32)).astype(np.uint32),
                          n.astype(np.uint32))
    return np.stack([b0, b1], axis=-1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` on raw key data -> ``uint32[2]``:
    the block of counter ``(0, data)``."""
    k = key_data(key)
    b0, b1 = threefry2x32(k[0], k[1], np.zeros(1, np.uint32),
                          np.asarray([data], np.uint32))
    return np.concatenate([b0, b1])

