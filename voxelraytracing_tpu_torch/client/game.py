"""Client game state: player + world + server connection glue.

Port of ``voxelraytracing_tpu/client/game.py``.

The reference's ``GameState`` (client/src/lib.rs:24-161): voxel edits apply
locally then echo to the server; chunk requests deduplicate and go out
nearest-first; the server command pump runs under a per-frame time budget;
chunk payloads land in the scrolling window (out-of-window ones are
discarded gracefully).
"""

import logging
import socket
import time
from dataclasses import dataclass, field

import numpy as np

from ..core.constants import CHUNK_SIZE
from ..core.svo import NoChunk, PosOutOfBounds, SetVoxelError
from ..net import ClientCmd, Conn, ServerCmd, protocol
from .player import Player
from .world import ClientWorld

# a plain module logger: importing configures no handler (entry points
# call utils.log.init_logging)
log = logging.getLogger(__name__)


class HandshakeDenied(Exception):
    pass


class ServerConn:
    """Client-side connection: blocking handshake, then buffered polling
    (client/src/net.rs:8-71)."""

    def __init__(self, conn: Conn, player_pos, voxel_pack):
        self.conn = conn
        self.player_pos = player_pos
        self.voxel_pack = voxel_pack

    @classmethod
    def establish(cls, addr, name, timeout=10.0):
        sock = socket.create_connection(addr, timeout=timeout)
        sock.settimeout(timeout)
        protocol.send_cmd(sock, ServerCmd.HANDSHAKE, name=name)
        cmd, fields = protocol.recv_cmd_blocking(sock)
        if cmd == ClientCmd.HANDSHAKE_DENIED:
            raise HandshakeDenied(fields.get("reason", ""))
        assert cmd == ClientCmd.HANDSHAKE_ACCEPTED, cmd
        sock.settimeout(None)
        return cls(Conn(sock), fields["spawn"], fields["voxel_pack"])

    def write(self, cmd, **kw):
        return self.conn.write(cmd, **kw)

    def try_read(self):
        return self.conn.try_read()

    def close(self):
        self.conn.close()


@dataclass
class CmdResult:
    kicked: bool = False
    kick_reason: str = ""
    updated_chunks: list = field(default_factory=list)  # (pos, start, n_nodes)
    received_oob_chunks: list = field(default_factory=list)


def voxel_pack_to_wire(pack):
    """VoxelPack -> JSON-able payload for HANDSHAKE_ACCEPTED."""
    return [{"name": v.name, "state": v.state} for v in pack]


class WireVoxelPack:
    """Voxel pack reconstructed from the handshake payload."""

    def __init__(self, entries):
        self.voxels = entries
        self._by_name = {e["name"]: i for i, e in enumerate(entries)}

    def by_name(self, name):
        return self._by_name[name]

    def get(self, vid):
        if 0 <= vid < len(self.voxels):
            e = self.voxels[vid]
            return type("V", (), {
                "name": e["name"],
                "state": e["state"],
                "is_solid": e["state"] == "solid",
                "is_air": e["state"] == "gas",
            })()
        return None

    def __len__(self):
        return len(self.voxels)


class GameState:
    def __init__(self, user_name, world: ClientWorld, server_conn: ServerConn):
        self.user_name = user_name
        self.world = world
        self.host = server_conn
        self.voxels = WireVoxelPack(server_conn.voxel_pack)
        self.player = Player(server_conn.player_pos, speed=0.2)
        self.chunk_requests_sent = set()
        self.voxel_data = {}  # req id -> (pos, voxel) answers
        self._next_voxel_req = 0

    # --------------------------------------------------------- world ops

    def set_voxel(self, pos, voxel):
        """Local-echo edit: apply to the window, then tell the server
        (client/src/lib.rs:67-76)."""
        if self.world.get_voxel(pos) == voxel:
            return None
        chunk = self.world.set_voxel(pos, voxel)
        self.host.write(ServerCmd.SET_VOXEL, pos=tuple(int(v) for v in pos), voxel=voxel)
        return chunk

    def request_voxel_data(self, pos):
        """Ask the server what voxel is at ``pos`` (GetVoxelData,
        common/src/net.rs:41). Returns the request id; the answer lands in
        ``self.voxel_data[req]`` on a later cmd pump."""
        req = self._next_voxel_req
        self._next_voxel_req += 1
        self.host.write(
            ServerCmd.GET_VOXEL_DATA, req=req,
            pos=tuple(int(v) for v in pos),
        )
        return req

    def center_chunks(self, anchor_chunk):
        evicted = self.world.center_chunks(anchor_chunk)
        if evicted:
            self.host.write(ServerCmd.UNLOAD_CHUNKS, chunks=evicted)
            for p in evicted:
                self.chunk_requests_sent.discard(p)

    def request_missing_chunks(self):
        """Nearest-first, deduplicated (client/src/lib.rs:80-108)."""
        empty = self.world.empty_chunks()
        center = self.player.pos

        def dist(c):
            mid = (np.asarray(c, np.float32) + 0.5) * CHUNK_SIZE
            return float(np.linalg.norm(mid - center))

        empty.sort(key=dist)
        to_load = [c for c in empty if c not in self.chunk_requests_sent]
        if to_load:
            if self.host.write(ServerCmd.LOAD_CHUNKS, chunks=to_load):
                self.chunk_requests_sent.update(to_load)

    # --------------------------------------------------------- cmd pump

    def process_cmd(self, cmd, fields, rs: CmdResult):
        if cmd == ClientCmd.GIVE_CHUNK_DATA:
            pos = tuple(fields["pos"])
            self.chunk_requests_sent.discard(pos)
            try:
                chunk = self.world.create_chunk(pos, fields["nodes"])
                rs.updated_chunks.append((pos, chunk.start, len(fields["nodes"])))
            except PosOutOfBounds:
                log.debug("discarding out-of-window chunk %s", pos)
                rs.received_oob_chunks.append(pos)
            except SetVoxelError:
                pass
        elif cmd == ClientCmd.KICK:
            log.warning("kicked by server: %s", fields.get("reason", ""))
            rs.kicked = True
            rs.kick_reason = fields.get("reason", "")
        elif cmd == ClientCmd.GIVE_NEW_POS:
            self.player.pos = np.asarray(fields["pos"], np.float32)
            self.player.cam_pos = self.player.desired_cam_pos()
        elif cmd == ClientCmd.GIVE_PLAYERS_LIST:
            self.players = fields["players"]
        elif cmd == ClientCmd.GIVE_VOXEL_DATA:
            self.voxel_data[fields["req"]] = (
                tuple(fields["pos"]), fields["voxel"]
            )

    def process_cmds_timeout(self, budget_s=0.2):
        """Drain pending server commands under a time budget
        (client/src/lib.rs:135-152)."""
        rs = CmdResult()
        deadline = time.monotonic() + budget_s
        while time.monotonic() < deadline:
            cmds = self.host.try_read()
            if not cmds:
                break
            for cmd, fields in cmds:
                self.process_cmd(cmd, fields, rs)
        return rs

    def disconnect(self):
        self.host.write(ServerCmd.DISCONNECT_NOTICE)
        self.host.close()
