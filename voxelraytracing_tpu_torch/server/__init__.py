"""World-authority server: chunk generation and the batched SVO rebuild
(the port of ``voxelraytracing_tpu/server``; persistence and the client
state come with the net/client/server slice)."""

from .world import ServerChunk, ServerWorld

__all__ = ["ServerChunk", "ServerWorld"]
