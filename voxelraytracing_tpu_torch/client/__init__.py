"""Headless client: game state, scrolling world window, player physics.

Port of ``voxelraytracing_tpu/client`` (host code).

The analog of the reference's ``client`` crate ("Does not provide any
graphics, just game-state", client/src/lib.rs:1-4). Rendering lives in
``models/`` / ``ops/``; this package owns the interactive state.
"""

from .game import CmdResult, GameState, HandshakeDenied, ServerConn
from .player import Player, PlayerInput, PlayerMovement, clip_aabb_movement
from .world import Chunk, ClientWorld

__all__ = [
    "Chunk",
    "ClientWorld",
    "CmdResult",
    "GameState",
    "HandshakeDenied",
    "Player",
    "PlayerInput",
    "PlayerMovement",
    "ServerConn",
    "clip_aabb_movement",
]
