"""Wire protocol: command enums + length-prefixed binary framing.

Port of ``voxelraytracing_tpu/net/protocol.py``, byte for byte.

The reference streams bincode-serialized enums over TCP with implicit
framing (decode errors mean "wait for more bytes", common/src/net.rs:8-55,
client/src/net.rs:44-60). Here frames are explicit — ``[u32 length]
[u16 cmd id][payload]`` little-endian — which removes the partial-decode
retry dance; a reader only ever decodes complete frames.

Command set mirrors the reference protocol surface:

  client -> server (ClientCmd... sent BY the server? naming follows the
  reference: ``ServerCmd`` = commands *for* the server, ``ClientCmd`` =
  commands *for* the client, common/src/net.rs:30-55):

    ServerCmd:  HANDSHAKE, UPDATE_MY_PLAYER_POS, UPDATE_MY_RENDER_DISTANCE,
                LOAD_CHUNKS, UNLOAD_CHUNKS, DISCONNECT_NOTICE,
                GET_PLAYERS_LIST, SET_VOXEL, GET_VOXEL_DATA
    ClientCmd:  HANDSHAKE_ACCEPTED, HANDSHAKE_DENIED, KICK,
                GIVE_PLAYERS_LIST, GIVE_CHUNK_DATA, GIVE_NEW_POS,
                GIVE_VOXEL_DATA

Chunk payloads carry the SVO node prefix as raw ``uint16`` bytes — the SVO
itself is the compression (uniform regions collapse), same as the
reference's ``Cow<[Node]>`` chunk sends (common/src/net.rs:53).
"""

import json
import struct
from enum import IntEnum

import numpy as np

_HEADER = struct.Struct("<IH")  # payload length, cmd id

# Frame-length ceiling. The largest legitimate frame is a GIVE_CHUNK_DATA
# with a full 37,449-node chunk (~75 KiB) or a HANDSHAKE_ACCEPTED carrying a
# big voxel-pack JSON; 8 MiB leaves lavish headroom while stopping a peer
# from declaring a ~4 GiB frame that the reader would buffer entirely.
MAX_FRAME_LEN = 8 << 20


class DecodeError(ValueError):
    """A frame that cannot be decoded (malformed, oversized, unknown cmd).

    Raised *after* the offending bytes have been consumed from the read
    buffer wherever possible, so a caller that catches it can keep the
    stream (or, more sensibly, drop the peer) without the buffer wedging
    on the same frame forever."""


class ServerCmd(IntEnum):
    """Commands addressed TO the server."""

    HANDSHAKE = 1
    UPDATE_MY_PLAYER_POS = 2
    UPDATE_MY_RENDER_DISTANCE = 3
    LOAD_CHUNKS = 4
    UNLOAD_CHUNKS = 5
    DISCONNECT_NOTICE = 6
    GET_PLAYERS_LIST = 7
    SET_VOXEL = 8
    GET_VOXEL_DATA = 9


class ClientCmd(IntEnum):
    """Commands addressed TO the client."""

    HANDSHAKE_ACCEPTED = 101
    HANDSHAKE_DENIED = 102
    KICK = 103
    GIVE_PLAYERS_LIST = 104
    GIVE_CHUNK_DATA = 105
    GIVE_NEW_POS = 106
    GIVE_VOXEL_DATA = 107


# ------------------------------------------------------------- payloads

def _pack_str(s):
    b = s.encode("utf-8")
    return struct.pack("<H", len(b)) + b


def _unpack_str(buf, off):
    (n,) = struct.unpack_from("<H", buf, off)
    off += 2
    return buf[off : off + n].decode("utf-8"), off + n


def _pack_ivec3(v):
    return struct.pack("<iii", int(v[0]), int(v[1]), int(v[2]))


def _pack_fvec3(v):
    return struct.pack("<fff", float(v[0]), float(v[1]), float(v[2]))


def encode(cmd, **kw):
    """Encode a command + fields into payload bytes."""
    if cmd == ServerCmd.HANDSHAKE:
        return _pack_str(kw["name"])
    if cmd == ServerCmd.UPDATE_MY_PLAYER_POS:
        return _pack_fvec3(kw["pos"])
    if cmd == ServerCmd.UPDATE_MY_RENDER_DISTANCE:
        return struct.pack("<I", kw["dist"])
    if cmd in (ServerCmd.LOAD_CHUNKS, ServerCmd.UNLOAD_CHUNKS):
        chunks = kw["chunks"]
        out = [struct.pack("<I", len(chunks))]
        out += [_pack_ivec3(c) for c in chunks]
        return b"".join(out)
    if cmd == ServerCmd.DISCONNECT_NOTICE:
        return b""
    if cmd == ServerCmd.GET_PLAYERS_LIST:
        return b""
    if cmd == ServerCmd.SET_VOXEL:
        return _pack_ivec3(kw["pos"]) + struct.pack("<H", kw["voxel"])
    if cmd == ServerCmd.GET_VOXEL_DATA:
        # GetVoxelData(u32 request id, VoxelPos) — common/src/net.rs:41.
        # A no-op in the reference on both sides; answered for real here.
        return struct.pack("<I", kw["req"]) + _pack_ivec3(kw["pos"])

    if cmd == ClientCmd.HANDSHAKE_ACCEPTED:
        pack = json.dumps(kw["voxel_pack"]).encode("utf-8")
        return (
            _pack_fvec3(kw["spawn"]) + struct.pack("<I", len(pack)) + pack
        )
    if cmd == ClientCmd.HANDSHAKE_DENIED:
        return _pack_str(kw.get("reason", ""))
    if cmd == ClientCmd.KICK:
        return _pack_str(kw.get("reason", ""))
    if cmd == ClientCmd.GIVE_PLAYERS_LIST:
        players = kw["players"]  # list of (id, name)
        out = [struct.pack("<I", len(players))]
        for pid, name in players:
            out.append(struct.pack("<Q", pid) + _pack_str(name))
        return b"".join(out)
    if cmd == ClientCmd.GIVE_CHUNK_DATA:
        nodes = np.asarray(kw["nodes"], dtype="<u2")
        return _pack_ivec3(kw["pos"]) + struct.pack("<I", len(nodes)) + nodes.tobytes()
    if cmd == ClientCmd.GIVE_NEW_POS:
        return _pack_fvec3(kw["pos"])
    if cmd == ClientCmd.GIVE_VOXEL_DATA:
        # GiveVoxelData(u32, VoxelPos, Voxel) — common/src/net.rs:52.
        return (
            struct.pack("<I", kw["req"])
            + _pack_ivec3(kw["pos"])
            + struct.pack("<H", kw["voxel"])
        )
    raise ValueError(f"unknown cmd {cmd!r}")


def decode(cmd_id, payload):
    """Decode payload bytes -> (cmd, dict of fields).

    Raises :class:`DecodeError` on any malformed payload: unknown command
    ids, truncated fields, or count fields inconsistent with the actual
    payload length (all attacker-controlled on the wire)."""
    try:
        return _decode(cmd_id, payload)
    except DecodeError:
        raise
    except (struct.error, ValueError, KeyError, IndexError,
            UnicodeDecodeError) as e:
        raise DecodeError(f"malformed frame (cmd_id={cmd_id}): {e}") from e


def _check_count(n, per_item, payload, off, what):
    if n > (len(payload) - off) // per_item:
        raise DecodeError(
            f"{what} count {n} exceeds payload ({len(payload)} bytes)"
        )


def _decode(cmd_id, payload):
    if cmd_id < 100:
        cmd = ServerCmd(cmd_id)
    else:
        cmd = ClientCmd(cmd_id)

    if cmd == ServerCmd.HANDSHAKE:
        name, _ = _unpack_str(payload, 0)
        return cmd, {"name": name}
    if cmd == ServerCmd.UPDATE_MY_PLAYER_POS:
        return cmd, {"pos": struct.unpack("<fff", payload)}
    if cmd == ServerCmd.UPDATE_MY_RENDER_DISTANCE:
        return cmd, {"dist": struct.unpack("<I", payload)[0]}
    if cmd in (ServerCmd.LOAD_CHUNKS, ServerCmd.UNLOAD_CHUNKS):
        (n,) = struct.unpack_from("<I", payload, 0)
        _check_count(n, 12, payload, 4, "chunk")
        chunks = [
            struct.unpack_from("<iii", payload, 4 + 12 * i) for i in range(n)
        ]
        return cmd, {"chunks": chunks}
    if cmd in (ServerCmd.DISCONNECT_NOTICE, ServerCmd.GET_PLAYERS_LIST):
        return cmd, {}
    if cmd == ServerCmd.SET_VOXEL:
        x, y, z, v = struct.unpack("<iiiH", payload)
        return cmd, {"pos": (x, y, z), "voxel": v}
    if cmd == ServerCmd.GET_VOXEL_DATA:
        req, x, y, z = struct.unpack("<Iiii", payload)
        return cmd, {"req": req, "pos": (x, y, z)}

    if cmd == ClientCmd.HANDSHAKE_ACCEPTED:
        spawn = struct.unpack_from("<fff", payload, 0)
        (n,) = struct.unpack_from("<I", payload, 12)
        pack = json.loads(payload[16 : 16 + n].decode("utf-8"))
        return cmd, {"spawn": spawn, "voxel_pack": pack}
    if cmd in (ClientCmd.HANDSHAKE_DENIED, ClientCmd.KICK):
        reason, _ = _unpack_str(payload, 0)
        return cmd, {"reason": reason}
    if cmd == ClientCmd.GIVE_PLAYERS_LIST:
        (n,) = struct.unpack_from("<I", payload, 0)
        _check_count(n, 10, payload, 4, "player")  # 8B id + ≥2B name
        off = 4
        players = []
        for _ in range(n):
            (pid,) = struct.unpack_from("<Q", payload, off)
            off += 8
            name, off = _unpack_str(payload, off)
            players.append((pid, name))
        return cmd, {"players": players}
    if cmd == ClientCmd.GIVE_CHUNK_DATA:
        pos = struct.unpack_from("<iii", payload, 0)
        (n,) = struct.unpack_from("<I", payload, 12)
        _check_count(n, 2, payload, 16, "node")
        nodes = np.frombuffer(payload, dtype="<u2", count=n, offset=16).copy()
        return cmd, {"pos": pos, "nodes": nodes}
    if cmd == ClientCmd.GIVE_NEW_POS:
        return cmd, {"pos": struct.unpack("<fff", payload)}
    if cmd == ClientCmd.GIVE_VOXEL_DATA:
        req, x, y, z, v = struct.unpack("<IiiiH", payload)
        return cmd, {"req": req, "pos": (x, y, z), "voxel": v}
    raise ValueError(f"unknown cmd {cmd!r}")


# ------------------------------------------------------------- framing

def frame(cmd, **kw):
    payload = encode(cmd, **kw)
    return _HEADER.pack(len(payload), int(cmd)) + payload


def send_cmd(sock, cmd, **kw):
    sock.sendall(frame(cmd, **kw))


def read_frames(buffer: bytearray):
    """Yield (cmd, fields) for every complete frame in ``buffer``,
    consuming them; leftover partial bytes stay.

    A frame that fails to decode (or declares an over-limit length) raises
    :class:`DecodeError` — after consuming everything up to and *including*
    the bad frame, so a caller that keeps the stream alive cannot wedge on
    it. Frames decoded before the bad one are lost; the sensible response
    to a malformed peer is to drop it anyway (server/src/lib.rs:344-352
    drops a client on any read error)."""
    out = []
    off = 0
    try:
        while len(buffer) - off >= _HEADER.size:
            length, cmd_id = _HEADER.unpack_from(buffer, off)
            if length > MAX_FRAME_LEN:
                off = len(buffer)  # cannot resync past a lying header
                raise DecodeError(f"frame length {length} exceeds limit")
            if len(buffer) - off - _HEADER.size < length:
                break
            payload = bytes(
                buffer[off + _HEADER.size : off + _HEADER.size + length]
            )
            off += _HEADER.size + length
            out.append(decode(cmd_id, payload))
    finally:
        del buffer[:off]
    return out


def recv_cmd_blocking(sock):
    """Read exactly one command (blocking). For handshakes."""
    head = _recv_exact(sock, _HEADER.size)
    length, cmd_id = _HEADER.unpack(head)
    if length > MAX_FRAME_LEN:
        raise DecodeError(f"frame length {length} exceeds limit")
    payload = _recv_exact(sock, length)
    return decode(cmd_id, payload)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("socket closed")
        buf += part
    return buf
