"""The port's client and server over localhost TCP, on the CPU.

tests/test_client_server.py's scenarios on the port's modules (Flatland,
seed 42, a 4³ window): handshake and streaming, the edit echo, the voxel
query, the player list and disconnect, the window scroll, the region-file
round trip, player physics and a malicious client. Then the wire and the
disk against the JAX package: JAX's ``ServerConn`` and ``net.protocol``
stream chunks from the port's server (nodes equal to the port client's),
and region files written by either package read back through the other.
JAX's ``ClientWorld`` is not used: its first chunk builds the JAX
package's native library in place.
"""

import socket
import struct
import time

import numpy as np
import pytest

from voxelraytracing_tpu_torch.client import (
    ClientWorld, GameState, PlayerInput, ServerConn)
from voxelraytracing_tpu_torch.net import ServerCmd
from voxelraytracing_tpu_torch.resources.packs import (
    Resources, builtin_respack_path)
from voxelraytracing_tpu_torch.server import ServerState, ServerWorld, WorldFs
from voxelraytracing_tpu_torch.worldgen import WorldGen

from torch_one_thread import torch_one_thread  # noqa: F401

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def pack():
    return Resources.load_from(builtin_respack_path()).datapacks["terra"]


@pytest.fixture(scope="module")
def gen(pack):
    return WorldGen.from_datapack(pack, seed=42, preset_name="Flatland", **CPU)


@pytest.fixture()
def server(pack, gen):
    state = ServerState(ServerWorld(gen), voxel_pack=pack.voxels)
    state.spawn = (16.5, 14.0, 16.5)
    port = state.start()
    yield state, port
    state.stop()


def pump(state, game, ticks=50, until=None):
    """Run server ticks + client pump until ``until()`` or budget."""
    rs = None
    for _ in range(ticks):
        state.handle_clients()
        state.update()
        state.update_world()
        rs = game.process_cmds_timeout(0.05)
        if until is not None and until(rs):
            break
        time.sleep(0.005)
    return rs


def connect(port, name="tester", window=4):
    conn = ServerConn.establish(("127.0.0.1", port), name)
    center = np.floor_divide(np.asarray(conn.player_pos, np.int64), 32)
    world = ClientWorld(center, max_nodes=1 << 20, size_in_chunks=window)
    return GameState(name, world, conn)


def stream(state, game, n=64):
    game.request_missing_chunks()
    pump(state, game, until=lambda rs: game.world.populated_count() >= n)


def test_handshake_and_chunk_streaming(server):
    state, port = server
    game = connect(port)
    assert game.voxels.by_name("air") == 0
    assert len(game.voxels) > 50
    stream(state, game)
    assert game.world.populated_count() == 64  # full 4³ window
    # flatland surface: grass at y=12
    grass = game.voxels.by_name("grass")
    assert game.world.get_voxel((5, 12, 5)) == grass
    assert game.world.get_voxel((5, 13, 5)) == 0
    assert game.world.highest_voxel_at(5, 5) in (12, 13)  # 12, or a tree
    assert all(c.native for c in game.world.chunks.values())


def test_set_voxel_echoes_to_other_clients(server):
    state, port = server
    a = connect(port, "alice")
    b = connect(port, "bob")
    stream(state, a)
    stream(state, b)
    stone = a.voxels.by_name("stone")
    a.set_voxel((8, 20, 8), stone)
    assert a.world.get_voxel((8, 20, 8)) == stone  # local echo

    def until(rs):
        try:
            return b.world.get_voxel((8, 20, 8)) == stone
        except Exception:
            return False

    pump(state, b, until=until)
    assert b.world.get_voxel((8, 20, 8)) == stone
    assert state.world.get_voxel((8, 20, 8)) == stone  # server authority


def test_voxel_data_query(server):
    """GetVoxelData -> GiveVoxelData over the wire, answered from the
    server's world after an edit."""
    state, port = server
    a = connect(port, "alice")
    stream(state, a)
    stone = a.voxels.by_name("stone")
    a.set_voxel((9, 20, 9), stone)
    pump(state, a, ticks=5)
    req = a.request_voxel_data((9, 20, 9))
    pump(state, a, until=lambda rs: req in a.voxel_data)
    assert a.voxel_data[req] == ((9, 20, 9), stone)


def test_players_list_and_disconnect(server):
    state, port = server
    a = connect(port, "alice")
    a.host.write(ServerCmd.GET_PLAYERS_LIST)
    pump(state, a, until=lambda rs: hasattr(a, "players"))
    assert any(name == "alice" for _, name in a.players)
    a.disconnect()
    for _ in range(40):
        state.handle_clients()
        state.update()
        if not state.clients:
            break
        time.sleep(0.005)
    assert not state.clients


def test_window_scroll_unloads_and_requests(server):
    state, port = server
    game = connect(port)
    stream(state, game)
    game.center_chunks((3, 0, 0))  # scroll +2 in x
    assert game.world.populated_count() < 64
    assert len(game.world.empty_chunks()) > 0
    stream(state, game)
    assert game.world.populated_count() == 64


def test_persistence_roundtrip(tmp_path, pack, gen):
    world = ServerWorld(gen)
    world.generate_chunks([(0, 0, 0), (1, 0, 0)])
    stone = pack.voxels.by_name("stone")
    world.set_voxel((3, 20, 3), stone)
    fs = WorldFs(str(tmp_path))
    fs.add_dirty_chunk((0, 0, 0))
    fs.add_dirty_chunk((1, 0, 0))
    assert fs.save(world) == 2
    assert (0, 0, 0) in fs.available_chunks
    # fresh fs + world: chunk comes back from disk including the edit
    world2 = ServerWorld(gen)
    assert world2.generate_chunks([(0, 0, 0)], fs=WorldFs(str(tmp_path))) \
        == [(0, 0, 0)]
    assert world2.get_voxel((3, 20, 3)) == stone
    assert world2.get_voxel((3, 12, 3)) == pack.voxels.by_name("grass")


def test_player_physics_on_flat_ground(server):
    state, port = server
    game = connect(port)
    stream(state, game)
    p = game.player
    p.pos = np.asarray([16.5, 16.0, 16.5], np.float32)

    def collisions(region):
        return game.world.get_collisions_w(region, game.voxels)

    # fall to the ground (surface at y=13 top face)
    for _ in range(200):
        p.update(p.process_input(1.0, PlayerInput()), collisions)
        if p.on_ground:
            break
    assert p.on_ground
    assert abs(p.pos[1] - 13.0) < 0.05
    # jump leaves the ground
    p.update(p.process_input(1.0, PlayerInput(jump=True)), collisions)
    assert p.pos[1] > 13.01
    assert p.jumped


def test_malicious_client_cannot_crash_server(server):
    """Garbage, oversized, and truncated frames from a raw socket do not
    take the server down, and honest clients keep working after."""
    state, port = server
    game = connect(port, "honest")
    game.request_missing_chunks()
    pump(state, game, until=lambda rs: game.world.populated_count() > 0)
    attacks = [
        b"\xff" * 64,                                   # not a frame
        struct.pack("<I", 0xFFFFFFFF) + b"A" * 64,      # 4 GiB declared
        struct.pack("<I", 12) + b"\x07" + b"B" * 11,    # unknown cmd id
        struct.pack("<I", 9) + b"\x02" + b"\x01",       # truncated payload
    ]
    for payload in attacks:
        s = socket.create_connection(("127.0.0.1", port), timeout=5)
        try:
            s.sendall(payload)
            pump(state, game, ticks=5)
        finally:
            s.close()
        pump(state, game, ticks=3)
    assert game.world.populated_count() > 0
    game2 = connect(port, "second")
    game2.request_missing_chunks()
    pump(state, game2, until=lambda rs: game2.world.populated_count() > 0)
    assert game2.world.populated_count() > 0


def test_jax_client_streams_from_the_port_server(server):
    """JAX's ServerConn and net.protocol handshake with the port's server,
    request chunks and decode chunk frames whose nodes equal those the
    port's client received for the same chunks."""
    from voxelraytracing_tpu.client.game import ServerConn as JaxServerConn
    from voxelraytracing_tpu.net import ServerCmd as JaxServerCmd

    state, port = server
    ours = connect(port, "port")
    stream(state, ours)
    conn = JaxServerConn.establish(("127.0.0.1", port), "jax")
    assert conn.voxel_pack[0]["name"] == "air"
    assert tuple(conn.player_pos) == pytest.approx(state.spawn)
    want = sorted(ours.world.chunks)[:8]
    assert conn.write(JaxServerCmd.LOAD_CHUNKS, chunks=want)
    got = {}
    for _ in range(100):
        state.handle_clients()
        state.update()
        for cmd, fields in conn.try_read():
            if cmd.name == "GIVE_CHUNK_DATA":
                got[tuple(fields["pos"])] = fields["nodes"]
        if len(got) >= len(want):
            break
        time.sleep(0.005)
    assert sorted(got) == want
    for p in want:
        c = ours.world.chunks[p]
        n = len(got[p])
        np.testing.assert_array_equal(
            ours.world.nodes[c.start:c.start + n], got[p].astype(np.int32))
    conn.close()


def test_region_files_cross_read(tmp_path):
    """A region file written by the port's WorldFs reads back through JAX's
    read_region, and one JAX writes through the port's, byte for byte."""
    from voxelraytracing_tpu.server import persistence as jp

    from voxelraytracing_tpu_torch.server import persistence as tp

    rng = np.random.default_rng(3)
    chunks = {(0, 1, 2): rng.integers(0, 1 << 16, 700, dtype=np.uint16),
              (-3, 0, 15): rng.integers(0, 1 << 16, 9, dtype=np.uint16)}
    a, b = tmp_path / "port.data", tmp_path / "jax.data"
    tp.write_region(str(a), chunks)
    jp.write_region(str(b), chunks)
    assert a.read_bytes() == b.read_bytes()
    for got in (jp.read_region(str(a)), tp.read_region(str(b))):
        assert sorted(got) == sorted(chunks)
        for k in chunks:
            np.testing.assert_array_equal(got[k], chunks[k])
    assert tp.region_of((-3, 0, 15)) == jp.region_of((-3, 0, 15)) == (-1, 0, 0)
    assert tp.region_path("w", (1, 2, 3)) == jp.region_path("w", (1, 2, 3))
