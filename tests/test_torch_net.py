"""The port's wire protocol against the JAX package's, byte for byte.

For every command of both enums the port's ``frame`` bytes equal JAX's,
and each side's ``read_frames`` decodes the other's frames to the same
fields; frames split at arbitrary boundaries decode once complete; the
malformed payloads of tests/test_net_protocol.py raise ``DecodeError`` on
both sides and are consumed; the port's ``Conn`` marks itself broken on
garbage and goes quiet.
"""

import socket
import struct
import time

import numpy as np
import pytest

from voxelraytracing_tpu.net import protocol as JP

from voxelraytracing_tpu_torch.net import ClientCmd, ServerCmd
from voxelraytracing_tpu_torch.net import protocol as P
from voxelraytracing_tpu_torch.net.conn import Conn

PACK = [{"name": "air", "state": "gas"}, {"name": "stone", "state": "solid"},
        {"name": "wätér", "state": "liquid"}]
FIELDS = {
    ServerCmd.HANDSHAKE: dict(name="ünïcode name"),
    ServerCmd.UPDATE_MY_PLAYER_POS: dict(pos=(1.5, -2.25, 1e7)),
    ServerCmd.UPDATE_MY_RENDER_DISTANCE: dict(dist=12),
    ServerCmd.LOAD_CHUNKS: dict(chunks=[(0, 1, 2), (-3, -4, -5)]),
    ServerCmd.UNLOAD_CHUNKS: dict(chunks=[(7, -8, 9)]),
    ServerCmd.DISCONNECT_NOTICE: {},
    ServerCmd.GET_PLAYERS_LIST: {},
    ServerCmd.SET_VOXEL: dict(pos=(-5, 70, 123456), voxel=42),
    ServerCmd.GET_VOXEL_DATA: dict(req=7, pos=(-5, 70, 123456)),
    ClientCmd.HANDSHAKE_ACCEPTED: dict(spawn=(0.5, 80.0, 0.5),
                                       voxel_pack=PACK),
    ClientCmd.HANDSHAKE_DENIED: dict(reason="server full"),
    ClientCmd.KICK: dict(reason="bye"),
    ClientCmd.GIVE_PLAYERS_LIST: dict(players=[(2**63, "a"), (7, "b")]),
    ClientCmd.GIVE_CHUNK_DATA: dict(
        pos=(1, -2, 3),
        nodes=np.random.default_rng(5).integers(0, 1 << 16, 1000,
                                                dtype=np.uint16)),
    ClientCmd.GIVE_NEW_POS: dict(pos=(1.5, -2.25, 3.0)),
    ClientCmd.GIVE_VOXEL_DATA: dict(req=7, pos=(-5, 70, 123456), voxel=42),
}


def _same(a, b):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b


def test_every_command_has_a_case():
    assert set(FIELDS) == set(ServerCmd) | set(ClientCmd)
    assert [(c.name, int(c)) for c in ServerCmd] == [
        (c.name, int(c)) for c in JP.ServerCmd]
    assert [(c.name, int(c)) for c in ClientCmd] == [
        (c.name, int(c)) for c in JP.ClientCmd]
    assert (P.MAX_FRAME_LEN, P._HEADER.format) == (
        JP.MAX_FRAME_LEN, JP._HEADER.format)


@pytest.mark.parametrize("cmd", list(FIELDS), ids=lambda c: c.name)
def test_frames_equal_and_cross_decode(cmd):
    kw = FIELDS[cmd]
    jcmd = type(cmd).__name__
    jcmd = getattr(JP, jcmd)(int(cmd))
    ours, theirs = P.frame(cmd, **kw), JP.frame(jcmd, **kw)
    assert ours == theirs
    for reader, data in ((P.read_frames, theirs), (JP.read_frames, ours)):
        buf = bytearray(data)
        (got_cmd, fields), = reader(buf)
        assert not buf and int(got_cmd) == int(cmd)
        assert sorted(fields) == sorted(kw)
        for k in kw:
            want = kw[k]
            if k in ("chunks", "players"):
                want = [tuple(v) for v in want]
            elif k in ("pos", "spawn"):
                want = tuple(np.float32(v) if isinstance(v, float) else v
                             for v in want)
            _same(np.asarray(want) if k == "nodes" else want, fields[k])


def test_partial_frames_buffer():
    """Frames split at arbitrary byte boundaries decode once complete."""
    stream = (P.frame(ServerCmd.SET_VOXEL, pos=(1, 2, 3), voxel=9)
              + JP.frame(JP.ServerCmd.DISCONNECT_NOTICE))
    buf = bytearray()
    got = []
    for i in range(0, len(stream), 3):
        buf.extend(stream[i:i + 3])
        got.extend(P.read_frames(buf))
    assert [c for c, _ in got] == [ServerCmd.SET_VOXEL,
                                   ServerCmd.DISCONNECT_NOTICE]
    assert not buf


MALFORMED = {
    "unknown command id": P._HEADER.pack(0, 99),
    "truncated payload": P._HEADER.pack(3, int(ServerCmd.SET_VOXEL)) + b"abc",
    "count past the payload": P._HEADER.pack(4, int(ServerCmd.LOAD_CHUNKS))
    + struct.pack("<I", 2**31),
    "oversized frame length": P._HEADER.pack(P.MAX_FRAME_LEN + 1,
                                             int(ServerCmd.HANDSHAKE)),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_frames_raise_on_both_sides(case):
    for mod in (P, JP):
        buf = bytearray(MALFORMED[case])
        with pytest.raises(mod.DecodeError):
            mod.read_frames(buf)
        assert not buf  # bad frame consumed — the buffer can't wedge


def test_conn_marks_broken_on_garbage():
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    b = socket.create_connection(lst.getsockname())
    a, _ = lst.accept()
    lst.close()
    try:
        conn = Conn(a)
        b.sendall(P._HEADER.pack(4, 9999) + b"\xff\xff\xff\xff")
        deadline = time.time() + 5
        frames = []
        while time.time() < deadline and not conn.broken:
            frames.extend(conn.try_read())
            time.sleep(0.005)
        assert conn.broken
        assert frames == []
        assert conn.try_read() == []  # broken conn goes quiet, never raises
        assert conn.write(ServerCmd.DISCONNECT_NOTICE) is False
    finally:
        a.close()
        b.close()
