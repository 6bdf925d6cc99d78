"""Data-driven resources: RON parsing, datapacks, stylepacks, worlds
(the port of ``voxelraytracing_tpu/resources``)."""

from .packs import (
    Datapack,
    Resources,
    Stylepack,
    VoxelPack,
    builtin_respack_path,
)

__all__ = [
    "Datapack",
    "Resources",
    "Stylepack",
    "VoxelPack",
    "builtin_respack_path",
]
