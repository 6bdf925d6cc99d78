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

The SVO path tracer (``models/pathtracer.py``) draws its scatter
directions with ``jax.random.normal``; :func:`normal` gives the same f32
words on any torch device:

* the bits: the Threefry block of key ``(k0, k1)`` on each element's
  flat index split into two words, the block's two words XOR-ed
  (``_threefry_random_bits_partitionable``);
* the uniform on ``[nextafter(-1, 0), 1)``: 23 mantissa bits under the
  exponent of 1.0, minus 1, times 2, plus the low end (``_uniform``);
* ``sqrt(2) * erf_inv(u)`` with the f32 ``ErfInv`` that XLA's CPU
  compiler emits, not ``torch.erfinv``: its degree-9 polynomial
  (stablehlo's ``materializeErfInvF32``) on ``w = -log1p(-u*u)``, with
  XLA's ``log1p`` (a Cephes rational below ``sqrt(2)-1``, else the Cephes
  ``log`` of ``1+x``). XLA contracts each ``a*b+c`` of these into one
  fused multiply-add; :func:`_fma` computes it exactly in float64 (the
  product of two floats is exact there) and rounds once to float32.

Every one of the 2**23 values the uniform can take maps to the word that
XLA's ``erf_inv`` gives (tests/test_torch_renderers.py).
"""

import numpy as np
import torch

from .camera import sqrt_rn

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


def threefry2x32_torch(k0, k1, x0, x1):
    """:func:`threefry2x32` on int64 tensors holding uint32 values (torch's
    uint32 has few CUDA ops): every sum is masked back to 32 bits."""
    k0, k1 = int(k0), int(k1)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & _M32)) & _M32
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


def random_bits(key, shape, device="cuda"):
    """``jax.random.bits(key, shape, uint32)``'s words as int64 tensors on
    ``device`` (the card unless the caller asks for the CPU): the two
    words of the block of each element's flat index, XOR-ed."""
    k = key_data(key)
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32_torch(k[0], k[1], idx >> 32, idx & _M32)
    return (b0 ^ b1).reshape(shape)


def _fma(a, b, c):
    """``a*b + c`` rounded once to float32, as XLA's contracted
    multiply-add: the float64 product of two float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def _const(x, v):
    return torch.full_like(x, float(np.float32(v)))


def _poly(x, coeffs):
    """Horner's rule from a zero start, one fused step a coefficient
    (XLA's ``EvaluatePolynomial`` under contraction)."""
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _const(x, c))
    return p


_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _log_xla(x):
    """XLA's f32 ``log`` on the CPU (the Cephes range reduction and
    polynomial) for finite ``x > 0``."""
    bits = x.view(torch.int32)
    e = (bits >> 23).float() - 126.0  # 1 + (exponent - 127)
    t = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    mask = t < float(np.float32(0.707106781186547524))
    tmp = torch.where(mask, t, torch.zeros_like(t))
    t = t - 1.0
    e = e - mask.float()
    t = t + tmp
    x2 = t * t
    x3 = x2 * t
    p = [_const(t, c) for c in _LOG_P]
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * float(np.float32(-2.12194440e-4)))
    t = _fma(_const(t, -0.5), x2, t)
    t = t + y
    return _fma(_const(t, 0.693359375), e, t)


def _log1p_xla(x):
    """XLA's f32 ``log1p`` (``EmitLog1p``) for ``x`` in ``(-1, 0]``."""
    x2 = x * x
    small = x.abs() < float(np.float32(0.41421356237309504880))
    r = _poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN)
    r = (x * x2) * r
    r = _fma(_const(x, -0.5), x2, r)
    r = x + r
    return torch.where(small, r, _log_xla(x + 1.0))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv_xla(x):
    """XLA's f32 ``erf_inv`` for ``x`` in ``(-1, 1)``: the words
    ``jax.lax.erf_inv`` gives on the CPU."""
    w = -_log1p_xla(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_rn(w) - 3.0)

    def coef(i):
        return torch.where(lt, _const(x, _ERFINV_LT5[i]),
                           _const(x, _ERFINV_GE5[i]))

    p = coef(0)
    for i in range(1, 9):
        p = _fma(p, w, coef(i))
    return p * x



def uniform_pm1(key, shape, device="cuda"):
    """``jax.random.uniform(key, shape, f32, nextafter(-1, 0), 1)``."""
    bits = random_bits(key, shape, device)
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return torch.clamp((fb - 1.0) * 2.0 + lo, min=lo)


def normal(key, shape, device="cuda"):
    """``jax.random.normal(key, shape, float32)`` on raw key data, word for
    word, on ``device`` (the card unless the caller asks for the CPU)."""
    u = uniform_pm1(key, shape, device)
    return erf_inv_xla(u) * float(np.float32(np.sqrt(2.0)))
