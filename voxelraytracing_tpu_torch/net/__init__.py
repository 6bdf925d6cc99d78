"""Client/server networking: framed binary protocol over TCP.

Port of ``voxelraytracing_tpu/net`` (host code, the same bytes on the
wire, so either package's client talks to either's server).
Control-plane only — chunk payloads and commands are host data; device
traffic (the render pipeline) never touches sockets (the reference's
bincode-on-TCP becomes an explicit length-prefixed frame protocol).
"""

from .protocol import (
    ClientCmd,
    ServerCmd,
    read_frames,
    recv_cmd_blocking,
    send_cmd,
)
from .conn import Conn, ConnClosed

__all__ = [
    "ClientCmd",
    "ServerCmd",
    "Conn",
    "ConnClosed",
    "read_frames",
    "recv_cmd_blocking",
    "send_cmd",
]
