"""Buffered non-blocking connection wrapper.

Port of ``voxelraytracing_tpu/net/conn.py``.

The polled-read pattern of the reference's connection types
(client/src/net.rs:44-60, server/src/net.rs:32-48): a non-blocking socket
drains into a byte buffer; complete frames decode immediately, partial
frames wait for more bytes. Writes flag the connection broken on failure so
the owner drops it on the next tick (server/src/net.rs:59-75).
"""

import socket

from . import protocol


class ConnClosed(Exception):
    pass


class Conn:
    """A framed, non-blocking command stream over TCP."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.sock.setblocking(False)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.buffer = bytearray()
        self.broken = False

    def try_read(self):
        """All complete commands available right now (never blocks).

        A malformed frame from the peer marks the connection broken (the
        owner drops it on its next tick) instead of propagating — one bad
        client must never take down the server loop."""
        if self.broken:
            return []
        try:
            while True:
                data = self.sock.recv(1 << 16)
                if not data:
                    self.broken = True
                    break
                self.buffer.extend(data)
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self.broken = True
        try:
            return protocol.read_frames(self.buffer)
        except protocol.DecodeError:
            self.broken = True
            return []

    def write(self, cmd, **kw):
        """Send one command; flags ``broken`` instead of raising."""
        if self.broken:
            return False
        try:
            self.sock.setblocking(True)
            try:
                protocol.send_cmd(self.sock, cmd, **kw)
            finally:
                self.sock.setblocking(False)
            return True
        except OSError:
            self.broken = True
            return False

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass
