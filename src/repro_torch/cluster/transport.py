"""Length-prefixed message transport for the process-cluster runtime.

One frame = 4-byte big-endian length + pickled body.  Bodies are small
tuples — ``("hello", wid, pid)``, ``("request", wid)``, ``("assign",
Chunk)``, ``("report", wid, Chunk, payload, dt, by)``, ``("wait",
poll)``, ``("error", wid, repr)``, ``("done",)`` — the exact
request/report vocabulary of ``repro_torch.core.engine``, serialized.

Sockets are AF_UNIX SOCK_STREAM (this runtime is a single-host physical
testbed; swapping the address family for TCP is a one-line change).
Pickle is acceptable because both ends are processes WE spawned on this
machine — nothing here listens for foreign connections.

``Connection.delay`` implements the ``msg_latency`` perturbation at the
transport layer: the master's per-worker handler sleeps ``delay``
after receiving and before sending, so one scheduling round trip costs
2×latency extra — matching the virtual-time engine's accounting.
``Connection.bytes_received`` counts the frame bytes read so far (the
master sums it into the run's payload bytes).
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import time
from typing import Any, Optional

_HDR = struct.Struct(">I")

# Frames are tiny control messages plus payloads (grad trees, token
# arrays).  Cap a single frame to catch runaway/corrupt headers early.
MAX_FRAME = 1 << 30


class TransportError(ConnectionError):
    pass


class Connection:
    """One framed, blocking, optionally-delayed duplex connection."""

    def __init__(self, sock: socket.socket, *, delay: float = 0.0):
        self.sock = sock
        self.delay = delay
        self.bytes_received = 0
        self._rbuf = bytearray()   # bytearray: O(chunk) appends, so a
                                   # multi-MB frame (gradient payloads)
                                   # is not re-copied per recv() step

    # ------------------------------------------------------------- send
    def send(self, msg: Any) -> None:
        if self.delay > 0.0:
            time.sleep(self.delay)
        data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            self.sock.sendall(_HDR.pack(len(data)) + data)
        except (BrokenPipeError, ConnectionResetError, OSError) as e:
            raise TransportError(str(e)) from e

    # ------------------------------------------------------------- recv
    def _read_exact(self, n: int) -> Optional[bytes]:
        while len(self._rbuf) < n:
            try:
                more = self.sock.recv(65536)
            except (ConnectionResetError, OSError):
                return None
            if not more:                       # EOF: peer died or closed
                return None
            self._rbuf += more
        out = bytes(self._rbuf[:n])
        del self._rbuf[:n]
        return out

    def recv(self) -> Optional[Any]:
        """Next message, or None on EOF / reset (peer gone)."""
        hdr = self._read_exact(_HDR.size)
        if hdr is None:
            return None
        (n,) = _HDR.unpack(hdr)
        if n > MAX_FRAME:
            raise TransportError(f"frame of {n} bytes exceeds MAX_FRAME")
        body = self._read_exact(n)
        if body is None:
            return None
        self.bytes_received += _HDR.size + n
        msg = pickle.loads(body)
        if self.delay > 0.0:
            time.sleep(self.delay)
        return msg

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def listen(path: str, backlog: int = 128) -> socket.socket:
    """Bind + listen on an AF_UNIX address (the master side)."""
    if os.path.exists(path):
        os.unlink(path)
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.bind(path)
    sock.listen(backlog)
    return sock


def connect(path: str, *, timeout: float = 30.0,
            retry_every: float = 0.02) -> Connection:
    """Connect to a master address, retrying until it is listening.

    Workers race the master's bind(); retry instead of ordering the
    startup.  Raises TransportError after ``timeout`` seconds.
    """
    deadline = time.monotonic() + timeout
    while True:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.connect(path)
            return Connection(sock)
        except (FileNotFoundError, ConnectionRefusedError, OSError):
            sock.close()
            if time.monotonic() > deadline:
                raise TransportError(
                    f"could not connect to {path} within {timeout}s")
            time.sleep(retry_every)
