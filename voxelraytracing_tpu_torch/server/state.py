"""Server runtime: client management, chunk serving, dirty broadcast.

Port of ``voxelraytracing_tpu/server/state.py``, on the port's
``ServerWorld``: chunk generation and the SVO build run on the
generator's device (the card unless it was built for the CPU).

The reference's ``ServerState`` (server/src/lib.rs:132-331): an accept
thread hands established clients over a queue; the tick loop polls client
commands, builds requested chunks (here: one batched device program instead
of a 16-thread builder pool), places deferred features, and broadcasts
dirty chunks to every client that wants them — skipping the client that
caused the edit.
"""

import logging
import queue
import socket
import threading
import random

from ..net import ClientCmd, Conn, ServerCmd, protocol
from .world import ServerWorld

# a plain module logger: importing configures no handler (entry points
# call utils.log.init_logging)
log = logging.getLogger(__name__)

CHUNK_BATCH = 128  # chunks generated per tick (server/src/lib.rs:248)


class Client:
    def __init__(self, cid, name, conn: Conn):
        self.id = cid
        self.name = name
        self.conn = conn
        self.pos = (0.0, 0.0, 0.0)
        self.render_distance = 0
        self.wants_chunks = False
        self.pending_chunks = set()


class ServerState:
    def __init__(
        self,
        world: ServerWorld,
        voxel_pack=None,
        host="127.0.0.1",
        port=0,
        max_players=64,
    ):
        from ..client.game import voxel_pack_to_wire

        self.world = world
        self.voxel_pack_wire = (
            voxel_pack_to_wire(voxel_pack) if voxel_pack is not None else []
        )
        self.host = host
        self.port = port
        self.max_players = max_players
        self.clients = {}
        self.new_clients = queue.Queue()
        self.kill = threading.Event()
        self.listener = None
        self.accept_thread = None
        self.spawn = None
        self.chunks_to_build = set()
        self.dirty_chunks = {}  # cpos -> source client id (None = server)

    # ------------------------------------------------------------ lifecycle

    def start(self):
        """Bind + spawn the accept thread (server/src/lib.rs:102-130)."""
        if self.spawn is None:
            land = self.world.gen.find_land_near(0, 0)
            if land is None:
                self.spawn = (0.5, 80.0, 0.5)
            else:
                x, h, z = land
                self.spawn = (x + 0.5, float(h + 1), z + 0.5)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((self.host, self.port))
        self.port = self.listener.getsockname()[1]
        self.listener.listen()
        self.listener.settimeout(0.2)
        self.accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True
        )
        self.accept_thread.start()
        return self.port

    def _accept_loop(self):
        pack_wire = self.voxel_pack_wire
        while not self.kill.is_set():
            try:
                sock, _ = self.listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                sock.settimeout(5.0)
                cmd, fields = protocol.recv_cmd_blocking(sock)
                if cmd != ServerCmd.HANDSHAKE:
                    sock.close()
                    continue
                if len(self.clients) >= self.max_players:
                    protocol.send_cmd(
                        sock, ClientCmd.HANDSHAKE_DENIED, reason="server full"
                    )
                    sock.close()
                    continue
                protocol.send_cmd(
                    sock,
                    ClientCmd.HANDSHAKE_ACCEPTED,
                    spawn=self.spawn,
                    voxel_pack=pack_wire,
                )
                sock.settimeout(None)
                client = Client(
                    random.getrandbits(64), fields["name"], Conn(sock)
                )
                self.new_clients.put(client)
            except (OSError, ValueError):
                try:
                    sock.close()
                except OSError:
                    pass

    def stop(self):
        self.kill.set()
        if self.listener is not None:
            try:
                self.listener.close()
            except OSError:
                pass
        for c in self.clients.values():
            c.conn.close()

    # ------------------------------------------------------------ tick

    def handle_clients(self):
        """Poll every client connection and act on its commands
        (server/src/lib.rs:267-330).

        Any error while reading or acting on a client's traffic — malformed
        frames already mark the conn broken in ``Conn.try_read``; this also
        catches semantically-invalid field values — flags that one client
        broken (dropped next tick) instead of crashing the tick loop, the
        same crash-only per-client policy as server/src/lib.rs:344-352."""
        for client in list(self.clients.values()):
            try:
                for cmd, fields in client.conn.try_read():
                    self._handle_cmd(client, cmd, fields)
            except Exception:
                log.warning(
                    "dropping client %016x (%s): bad frame",
                    client.id, client.name, exc_info=True,
                )
                client.conn.broken = True

    def _handle_cmd(self, client, cmd, fields):
        if cmd == ServerCmd.UPDATE_MY_PLAYER_POS:
            client.pos = fields["pos"]
        elif cmd == ServerCmd.UPDATE_MY_RENDER_DISTANCE:
            client.render_distance = fields["dist"]
        elif cmd == ServerCmd.LOAD_CHUNKS:
            client.wants_chunks = True
            for cpos in fields["chunks"]:
                cpos = tuple(cpos)
                chunk = self.world.get_chunk(cpos)
                if chunk is not None:
                    nodes = self.world.build_nodes([cpos])[cpos]
                    client.conn.write(
                        ClientCmd.GIVE_CHUNK_DATA, pos=cpos, nodes=nodes
                    )
                else:
                    self.chunks_to_build.add(cpos)
                    client.pending_chunks.add(cpos)
        elif cmd == ServerCmd.UNLOAD_CHUNKS:
            for cpos in fields["chunks"]:
                client.pending_chunks.discard(tuple(cpos))
        elif cmd == ServerCmd.SET_VOXEL:
            cpos = self.world.set_voxel(fields["pos"], fields["voxel"])
            if cpos is not None:
                self.dirty_chunks[cpos] = client.id
                if self.fs is not None:
                    self.fs.add_dirty_chunk(cpos)
        elif cmd == ServerCmd.GET_PLAYERS_LIST:
            players = [(c.id, c.name) for c in self.clients.values()]
            client.conn.write(ClientCmd.GIVE_PLAYERS_LIST, players=players)
        elif cmd == ServerCmd.GET_VOXEL_DATA:
            # Wire parity with common/src/net.rs:41,52. The reference leaves
            # both sides as no-ops (server/src/lib.rs:309); here the server
            # actually answers from world state (0 for unloaded chunks).
            vox = self.world.get_voxel(tuple(fields["pos"])) or 0
            client.conn.write(
                ClientCmd.GIVE_VOXEL_DATA,
                req=fields["req"], pos=tuple(fields["pos"]), voxel=int(vox),
            )
        elif cmd == ServerCmd.DISCONNECT_NOTICE:
            client.conn.broken = True

    fs = None  # optional WorldFs persistence backend

    def update(self, fs=None):
        """One server tick (server/src/lib.rs:198-261)."""
        self.fs = fs
        # drain newly accepted clients
        while True:
            try:
                client = self.new_clients.get_nowait()
            except queue.Empty:
                break
            self.clients[client.id] = client
            log.info("client %016x (%s) joined", client.id, client.name)
        # drop broken connections
        for cid in [c for c, cl in self.clients.items() if cl.conn.broken]:
            dropped = self.clients.pop(cid)
            dropped.conn.close()
            log.info("client %016x (%s) disconnected", cid, dropped.name)

        # build requested chunks, batched
        if self.chunks_to_build:
            batch = list(self.chunks_to_build)[:CHUNK_BATCH]
            self.chunks_to_build.difference_update(batch)
            built = self.world.generate_chunks(batch, fs=fs)
            for cpos in built:
                self.dirty_chunks.setdefault(cpos, None)

        # broadcast dirty chunks (server/src/lib.rs:216-236)
        if self.dirty_chunks:
            nodes_by_pos = self.world.build_nodes(list(self.dirty_chunks))
            for cpos, source in self.dirty_chunks.items():
                nodes = nodes_by_pos.get(cpos)
                if nodes is None:
                    continue
                for client in self.clients.values():
                    if not client.wants_chunks or client.id == source:
                        continue
                    if client.conn.write(
                        ClientCmd.GIVE_CHUNK_DATA, pos=cpos, nodes=nodes
                    ):
                        client.pending_chunks.discard(cpos)
            self.dirty_chunks.clear()

    def update_world(self):
        """Deferred feature placement (server/src/lib.rs:263-265)."""
        touched = self.world.place_features()
        for cpos in touched:
            self.dirty_chunks.setdefault(cpos, None)
            if self.fs is not None:
                self.fs.add_dirty_chunk(cpos)

    def teleport(self, client_id, pos):
        client = self.clients.get(client_id)
        if client is not None:
            client.conn.write(ClientCmd.GIVE_NEW_POS, pos=pos)
