"""Carry a world built by the JAX package over to the port.

The JAX package's ``RenderGrid``, ``RenderGrid3`` and ``PreparedGrid4``
hold uint32 bit words; the port holds the same bits as int32 tensors. These functions take
the JAX arrays as NumPy (``np.asarray`` of each field) and return the
port's structures on ``device`` (the card unless the caller asks for the
CPU), so one world can feed both packages.
"""

import numpy as np

from .ops.wavefront import RenderGrid, _i32
from .ops.wavefront3 import RenderGrid3
from .ops.wavefront4 import PreparedGrid4, PreparedGrid4Sparse


def render_grid_from_numpy(bwin, lwin, brick_dir, bricks, world_min, to_pack,
                           n_liquid, size_voxels, *, device="cuda"):
    """The fields of a JAX v1 ``RenderGrid``, in its order, as NumPy -> the
    port's RenderGrid on ``device``."""
    return RenderGrid(
        *[_i32(p, device) for p in (bwin, lwin, brick_dir, bricks)],
        world_min=_i32(np.asarray(world_min, np.int32), device),
        to_pack=_i32(np.asarray(to_pack, np.int32), device),
        n_liquid=int(n_liquid),
        size_voxels=int(size_voxels),
    )


def render_grid3_from_numpy(gw_jump, gw_liq, wmeta, sw_meta, sw_solid,
                            sw_liq, sw_pid, brick_dir, bricks, world_min,
                            to_pack, n_liquid, size_voxels, palettes_ok, *,
                            device="cuda"):
    """The fields of a JAX ``RenderGrid3``, in its order, as NumPy -> the
    port's RenderGrid3 on ``device``."""
    planes = (gw_jump, gw_liq, wmeta, sw_meta, sw_solid, sw_liq, sw_pid,
              brick_dir, bricks)
    return RenderGrid3(
        *[_i32(p, device) for p in planes],
        world_min=_i32(np.asarray(world_min, np.int32), device),
        to_pack=_i32(np.asarray(to_pack, np.int32), device),
        n_liquid=int(n_liquid),
        size_voxels=int(size_voxels),
        palettes_ok=bool(palettes_ok),
    )


def prepared_from_numpy(sw_cont, wmeta_pad, *, device="cuda"):
    """JAX ``PreparedGrid4`` tables (uint32 arrays) -> the port's."""
    return PreparedGrid4(_i32(np.asarray(sw_cont), device),
                         _i32(np.asarray(wmeta_pad), device))


def prepared_sparse_from_numpy(sw_cont, wmeta_pad, ns, *, device="cuda"):
    """JAX ``PreparedGrid4Sparse`` tables (uint32 arrays) and its ``ns``
    -> the port's."""
    return PreparedGrid4Sparse(_i32(np.asarray(sw_cont), device),
                               _i32(np.asarray(wmeta_pad), device), int(ns))
