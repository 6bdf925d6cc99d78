"""The one-launch path tracer: ``path_trace_fused4``.

Port of ``voxelraytracing_tpu/ops/pathtrace4.py`` (``_pt_kernel4`` :101,
launched by ``_pt_frame4`` :848, and ``path_trace_fused4`` :951). The TPU
kernel carries every ray of a 64-tile block through its legs inside one
program: it marches in serve rounds against a VMEM cache, and at round
boundaries shades each finished leg, scatters the rays that hit and
marches them on, until all rays are done or ``rounds`` runs out (rays cut
off there shade as sky). The cache, the rounds and the serve knobs are
schedule; the port keeps the converged semantics: each pixel's thread
runs, for every sample, its camera ray and then its legs to their ends.

:func:`pt4` launches ``csrc/pathtrace4.cu`` on CUDA tensors; on CPU
tensors it runs the plain version :func:`pt4_ref`, which walks the legs
as wavefronts with the march of :func:`~.wavefront4._leg_ref` and the
leg-end math of :mod:`.pathtrace3`. The route differs from
``path_trace3`` only in its draws: the hash base of a leg is the
sample's (from the key's 16-bit seed quads and the sample index, no
Threefry) xor ``bounces_left * 0x9E3779B9`` (pathtrace4.py:557-571,
:726-730). On paths that draw nothing (no bounce, or mirror materials)
both routes give the same frame.
"""

import ctypes

import numpy as np
import torch

from .. import _build
from .pathtrace3 import (
    _GOLDEN,
    _M32,
    _bounce_rays,
    _fresh_path,
    _leg_shade,
    _leg_water,
    _mat_rows,
    pt_inputs,
    ray_ids,
)
from .wavefront4 import (
    _check,
    _camera_rays,
    _decode_vox_ref,
    _device_of,
    _leg_ref,
    _pixels,
    _run,
    _strictly_inside,
    _table_args,
    _tile_ok,
    _world_dims,
    _world_of,
)


def _seed_base(sf, sample):
    """The hash base of one sample: the key words rebuilt from their
    16-bit quads (``sf[34:38]``), ``k0 ^ k1*0x9E3779B9 ^
    sample*0x7FEB352D``."""
    s0, s1, s2, s3 = (int(x) for x in sf[34:38])
    k0, k1 = s0 + (s1 << 16), s2 + (s3 << 16)
    return k0 ^ ((k1 * _GOLDEN) & _M32) ^ ((sample * 0x7FEB352D) & _M32)


def pt4_run(scal, gw2, mlut, sw_cont, wmeta_pad, *, height, width, bounces,
            samples):
    """:func:`pt4_ref`'s radiance and what its legs did: ``(radiance,
    steps, legs)``, the march steps and the rays marched, summed over all
    samples and legs."""
    wd, sf = _world_of(scal, gw2, sw_cont, wmeta_pad)
    dev = sw_cont.device
    pxi, pyi = _pixels(height, width, dev)
    valid = _tile_ok(sf, pxi, pyi)
    rid = ray_ids(pxi, pyi, int(sf[25]) * 16, int(sf[26]) * 8)
    cam = _camera_rays(sf, pxi, pyi)
    in_w0 = bool(_strictly_inside(wd.v, *sf[:3]))
    steps = legs = 0
    acc = torch.zeros((pxi.numel(), 3), dtype=torch.float32, device=dev)
    for sample in range(samples):
        base = _seed_base(sf, sample)
        rays, live = cam, valid
        active = valid & in_w0
        path = _fresh_path(pxi.numel(), dev)
        for bl in range(bounces, -1, -1):
            t_exit, t, hit, axm, wa, we, stp = _leg_ref(wd, *rays, active)
            steps += int(stp.sum())
            legs += int(active.sum())
            vox = _decode_vox_ref(wd, *rays, t, hit)
            mat = _mat_rows(mlut, vox)
            path, live = _leg_shade(sf, path, rays, live, hit,
                                    _leg_water(t, wa, we, t_exit), mat)
            if not bl:
                break
            rays = _bounce_rays(rays, t, axm, mat.scatter, rid,
                                base ^ ((bl * _GOLDEN) & _M32))
            active = live
        acc = acc + torch.stack(path[3:], dim=-1)
    return (acc * (1.0 / samples)).reshape(height, width, 3), steps, legs


def pt4_ref(scal, gw2, mlut, sw_cont, wmeta_pad, *, height, width, bounces,
            samples):
    """Plain PyTorch version of the one-launch path tracer.

    ``scal`` is the f32[43] row of :func:`~.pathtrace3.pt_scal`, ``gw2``
    i32[2,128] pair plane, ``mlut`` the f32[10,128] material LUT,
    ``sw_cont``/``wmeta_pad`` the packed tables, all on one device.
    Pixels of a whole 16x8 tile trace ``samples`` paths of up to
    ``bounces`` bounces from the camera (a camera outside the world sees
    sky); the rest stay black. Returns f32[height, width, 3] radiance,
    the mean over the samples."""
    return pt4_run(scal, gw2, mlut, sw_cont, wmeta_pad, height=height,
                   width=width, bounces=bounces, samples=samples)[0]


def pt4(scal, gw2, mlut, sw_cont, wmeta_pad, *, height, width, bounces,
        samples):
    """One-launch path-traced frame -> f32[height, width, 3].

    On CUDA tensors: one launch of ``csrc/pathtrace4.cu``; on CPU tensors:
    the plain version :func:`pt4_ref`. Any other device raises. Same
    arguments as :func:`pt4_ref`."""
    dev = _device_of(sw_cont, "pt4")
    if dev.type == "cpu":
        return pt4_ref(scal, gw2, mlut, sw_cont, wmeta_pad, height=height,
                       width=width, bounces=bounces, samples=samples)
    if bounces < 0 or samples < 1:
        raise ValueError(f"bounces={bounces}, samples={samples}")
    _check(dev, _table_args(scal, gw2, sw_cont, wmeta_pad)
           + [("mlut", mlut, torch.float32, (10, 128))])
    nw, ns, gs = _world_dims(sw_cont, wmeta_pad)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    _run(dev, "pt4", _build.load("pathtrace4").pt4_launch,
         scal.data_ptr(), gw2.data_ptr(), mlut.data_ptr(), sw_cont.data_ptr(),
         wmeta_pad.data_ptr(), out.data_ptr(), height, width, nw, ns, gs,
         int(bounces), int(samples),
         ctypes.c_float(float(np.float32(1.0 / samples))))
    pt4.launches += 1
    return out


pt4.launches = 0  # kernel launches since the last reset


def path_trace_fused4(rg, cam, materials, *, world_min=None,
                      sky_color=(0.81, 0.93, 1.0),
                      sun_pos=(0.0, 10_000.0, 0.0), sun_intensity=4.0,
                      bounces=1, samples=1, key=None, rounds=24,
                      steps_per_round=48, step_cap=None, interpret=None,
                      prepared=None, blk=64, n_sc=None, s_ins=None,
                      w_ins=None, s_seg=1):
    """Path-traced frame in one kernel launch -> f32[H,W,3] linear
    radiance (the sample mean), on the grid's device.

    The signature of the JAX ``path_trace_fused4``. ``key`` is raw key
    data ``uint32[2]`` (``np.asarray(jax.random.PRNGKey(k))``), None for
    ``PRNGKey(0)``; its words seed the draws directly. ``rounds``,
    ``steps_per_round``, ``interpret``, ``blk``, ``n_sc``, ``s_ins``,
    ``w_ins`` and ``s_seg`` are TPU schedule and are ignored: the port
    runs every leg to its end, the frame JAX converges to. Equals
    :func:`~.pathtrace3.path_trace3` where nothing is drawn (``bounces=0``
    or mirror materials).
    """
    del rounds, steps_per_round, interpret, blk, n_sc, s_ins, w_ins, s_seg
    args, (h, w) = pt_inputs(rg, cam, materials, world_min=world_min,
                             sky_color=sky_color, sun_pos=sun_pos,
                             sun_intensity=sun_intensity, step_cap=step_cap,
                             key=key, prepared=prepared)
    return pt4(*args, height=h, width=w, bounces=int(bounces),
               samples=int(samples))
