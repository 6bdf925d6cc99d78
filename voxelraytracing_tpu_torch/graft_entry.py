"""Entry points of the port: a single-device forward step and a multi-device
dry run.

Port of the JAX package's root ``__graft_entry__.py``.

``entry()`` returns the flagship forward step: the split v4 frame
(``touched4`` + ``march_planes4`` on the camera rays, then ``shade4``) on
the 4-chunk demo world at 128x128, with its example arguments.

``dryrun_multichip(n)`` runs the engine's full multi-device frame step on
an ``n``-device ``(samples, rays)`` mesh — demo chunk grids, the batched
chunk SVO build and the world assembly on the first device, then
:func:`~.parallel.sharded_accumulate_step` (the rows banded over the
``rays`` axis, jittered samples summed over the ``samples`` axis) — then
the band-sharded v3 and v4 frames (:func:`~.parallel.sharded_render_frame3`
and ``sharded_render_frame4``) on the ``rays`` axis.

    python -m voxelraytracing_tpu_torch.graft_entry

runs both on the card (every card for the dry run).
"""

import numpy as np
import torch

from .core.constants import CHUNK_SIZE


def _camera(world_voxels, width, height):
    from .ops.camera import CamData

    eye = (world_voxels * 0.5, world_voxels * 0.62, world_voxels * 0.5)
    return CamData.create(
        rot_deg=(30.0, 45.0, 0.0), eye=eye, fov_deg=70.0,
        proj_size=(width, height))


def _demo_grid3(w_chunks, materials, device):
    """The demo terrain of ``w_chunks``³ chunks as a RenderGrid3 on
    ``device``."""
    from .ops import noise
    from .ops.wavefront3 import build_render_grid3_host
    from .world.demo import demo_chunk_grids_host

    grids, cells = demo_chunk_grids_host(
        noise.make_permutation(7), np.zeros(3, np.int64), w_chunks,
        w_chunks * 32 * 0.45, int(w_chunks * 32 * 0.28))
    return build_render_grid3_host(grids, cells, np.zeros(3, np.int32),
                                   w_chunks, materials, device=device)


def entry(device="cuda"):
    """``(fn, example_args)``: the split v4 frame at 128x128 on the 4-chunk
    demo world (12 rounds of 8 sub-rounds set the heatmap scale, a
    500-step cap, no shadows), as the JAX entry sets it up. ``fn(*args)``
    returns the red channel as f32 [128, 128] in [0, 1] on ``device``
    (the card unless the caller asks for the CPU). ``example_args``: the
    host f32[43] scalar row, the pair plane, the colour LUT and the packed
    tables on ``device``."""
    from .ops.camera import _f32
    from .ops.wavefront4 import _frame_inputs, _render_frame4
    from .world.demo import demo_materials

    width, height, w_chunks = 128, 128, 4
    materials = demo_materials()
    rg = _demo_grid3(w_chunks, materials, device)
    cam = _camera(w_chunks * CHUNK_SIZE, width, height)
    row, args, kw = _frame_inputs(
        rg, cam, materials.color, sky_color=(0.81, 0.93, 1.0),
        sun_pos=(64.0, 10_000.0, 64.0), sun_intensity=4.0,
        shadow_ambient=0.4, show_steps=False, shadows=False, rounds=12,
        steps_per_round=64, step_cap=500, prepared=None)

    def forward(*frame_args):
        packed, _fl = _render_frame4(*frame_args, **kw)
        # the image as f32, so mean()/shape checks see a render product
        return (packed & 0xFF).to(torch.float32) / _f32(255.0, packed.device)

    return forward, (row, *args)


def dryrun_multichip(n_devices, device="cuda"):
    """Run ONE sharded frame step over an ``n_devices``-device mesh: the
    cards ``cuda:0 .. cuda:n-1`` (raises if there are fewer), or ``n``
    times the CPU with ``device="cpu"``. Returns the accumulated frame and
    the v3 and v4 band frames, each on the mesh's first device."""
    from .ops import noise
    from .ops.svo_build import build_chunk_svo_batch
    from .parallel.render import (
        make_mesh, sharded_accumulate_step, sharded_render_frame3,
        sharded_render_frame4)
    from .world.assemble import assemble_world_slice
    from .world.demo import demo_chunk_grids, demo_materials

    n_devices = int(n_devices)
    if torch.device(device).type == "cpu":
        devices = ["cpu"] * n_devices
    else:
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs "
                               f"{n_devices} CUDA cards, found {have}")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    n_samples = 2 if (n_devices % 2 == 0 and n_devices >= 2) else 1
    n_rays = n_devices // n_samples
    mesh = make_mesh(n_samples=n_samples, n_rays=n_rays, devices=devices)
    dev0 = mesh.devices[0, 0]

    w_chunks = 2
    width, band_height = 32, 8
    materials = demo_materials()
    cam = _camera(w_chunks * CHUNK_SIZE, width, band_height * n_rays)
    step = sharded_accumulate_step(mesh, materials, width=width,
                                   band_height=band_height, max_steps=24)

    perm = torch.from_numpy(noise.make_permutation(7)).to(dev0)
    min_chunk = np.zeros(3, np.int32)
    grids, cells = demo_chunk_grids(perm, min_chunk, w_chunks, 40.0, 18,
                                    device=dev0)
    nodes, _ = build_chunk_svo_batch(grids, device=dev0)
    world = assemble_world_slice(nodes, cells, min_chunk * CHUNK_SIZE,
                                 w_chunks, device=dev0)
    img = step(world.nodes, world.chunk_roots, world.world_min,
               cam.inv_view, cam.inv_proj, cam.pos, 0.05)
    assert img.shape == (band_height * n_rays, width, 3), img.shape
    assert bool(torch.isfinite(img).all())

    # the v3 and v4 frames with one 8-row tile band a device (each band
    # equal to the single-device frame's rows, tests/test_torch_parallel.py)
    rg3 = _demo_grid3(w_chunks, materials, dev0)
    h3 = n_rays * 8
    cam3 = _camera(w_chunks * CHUNK_SIZE, 64, h3)
    mesh_r = make_mesh(n_samples=1, n_rays=n_rays, devices=devices[:n_rays])
    img3 = sharded_render_frame3(mesh_r, rg3, cam3, materials.color, rounds=4)
    assert img3.shape == (h3, 64), img3.shape
    img4 = sharded_render_frame4(mesh_r, rg3, cam3, materials.color)
    assert img4.shape == (h3, 64), img4.shape
    return img, img3, img4


def main():
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), float(out.mean()))
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
