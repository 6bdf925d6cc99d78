# Frozen copy of voxelraytracing_tpu_torch/ops/materials.py at commit 5046bbb1c27cf55a0e0985dd2724f80b90766057
# (the benchmark's yardstick: later changes to the program do not reach it).
# Copied unchanged.

"""Per-voxel material tables.

Port of ``voxelraytracing_tpu/ops/materials.py``. The table stays on the
host as NumPy arrays, as in the JAX package: the host builders read it
(render-id maps, solidity) and the renderer turns its colors into the
[6,128] LUT it uploads with each frame.
"""

from typing import NamedTuple

import numpy as np


class MaterialTable(NamedTuple):
    color: np.ndarray  # f32[V, 3]
    is_empty: np.ndarray  # bool[V] — gas voxels
    is_liquid: np.ndarray  # bool[V]
    scatter: np.ndarray  # f32[V] — 1 = fully diffuse, 0 = mirror
    emission: np.ndarray  # f32[V] — emitted radiance scale (path tracer)

    @property
    def n_voxels(self):
        return self.color.shape[0]


def make_material_table(n_voxels, styles):
    """Build a MaterialTable from ``{voxel_id: style}``.

    ``styles`` values need ``color`` (3-seq), ``state`` (one of "solid",
    "liquid", "gas"), and optionally ``scatter`` / ``emission`` attributes or
    keys. Unstyled ids get the zero material, like the reference's
    ``Material::ZERO`` fallback (graphics/mod.rs:29-36, 49-60).
    """
    color = np.zeros((n_voxels, 3), dtype=np.float32)
    is_empty = np.zeros(n_voxels, dtype=bool)
    is_liquid = np.zeros(n_voxels, dtype=bool)
    scatter = np.zeros(n_voxels, dtype=np.float32)
    emission = np.zeros(n_voxels, dtype=np.float32)
    for vid, style in styles.items():
        if vid >= n_voxels:
            continue

        def get(key, default):
            if isinstance(style, dict):
                v = style.get(key, default)
            else:
                v = getattr(style, key, default)
            return default if v is None else v

        color[vid] = np.asarray(get("color", (0.0, 0.0, 0.0)), dtype=np.float32)
        state = get("state", "solid")
        is_empty[vid] = state == "gas"
        is_liquid[vid] = state == "liquid"
        scatter[vid] = float(get("scatter", 1.0))
        emission[vid] = float(get("emission", 0.0))
    return MaterialTable(
        color=color,
        is_empty=is_empty,
        is_liquid=is_liquid,
        scatter=scatter,
        emission=emission,
    )
