"""World-authority server: chunk generation/serving, clients, persistence.

Port of ``voxelraytracing_tpu/server``: the batched device worldgen and
SVO rebuild (``world.py``), the client runtime (``state.py``) and the
region files (``persistence.py``).
"""

from .persistence import WorldFs, read_region, write_region
from .state import Client, ServerState
from .world import ServerChunk, ServerWorld

__all__ = [
    "Client",
    "ServerChunk",
    "ServerState",
    "ServerWorld",
    "WorldFs",
    "read_region",
    "write_region",
]
