"""A WebSocket client of the stream server, as the browser viewer is one.

It connects to ``/ws`` and then runs one loop on one thread
(:meth:`Client.pump`): it waits on the socket until the next event is
due, sends each event at its due time as a masked JSON text frame, and
takes each binary frame as it completes, keeping its receipt time and
the header fields the benchmark reads. One thread, so a send never waits
for a read to give up the interpreter.

Wire header (little-endian, 40 bytes): magic 'PSIM', mode, count,
frame_id, total_particles, fps, update_ms, reflected_seq,
input_to_frame_ms, flags (bit 0: paused).
"""

from __future__ import annotations

import base64
import json
import os
import select
import socket
import struct
import time
from typing import Callable, List, NamedTuple, Optional, Sequence

HEADER_FMT = "<IIIIIffIfI"
HEADER_BYTES = struct.calcsize(HEADER_FMT)
MAGIC = 0x4D495350
FLAG_PAUSED = 1


class Header(NamedTuple):
    magic: int
    mode: int
    count: int
    frame_id: int
    total: int
    fps: float
    update_ms: float
    reflected_seq: int
    input_to_frame_ms: float
    flags: int


class Received(NamedTuple):
    t: float            # perf_counter when the frame's last byte was read
    header: Header


class Client:
    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((
            "GET /ws HTTP/1.1\r\nHost: {h}:{p}\r\nUpgrade: websocket\r\n"
            "Connection: Upgrade\r\nSec-WebSocket-Key: {k}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n").format(
                h=host, p=port, k=key).encode())
        reply = b""
        while b"\r\n\r\n" not in reply:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("server closed during the handshake")
            reply += chunk
        head, _, rest = reply.partition(b"\r\n\r\n")
        if b" 101 " not in head.split(b"\r\n")[0]:
            raise ConnectionError(f"no upgrade: {head[:80]!r}")
        self.sock.settimeout(None)
        self._buf = bytearray(rest)
        self._off = 0
        self._chunk = bytearray(1 << 22)
        self._chunk_view = memoryview(self._chunk)
        self.frames: List[Received] = []
        self.keep_paused = False
        self.paused_frame: Optional[bytes] = None
        self.late: List[float] = []     # send time - due time, each event

    # -- reading ----------------------------------------------------------------
    def _parse(self, t: float) -> None:
        """Take every complete frame in the buffer (from ``_off``)."""
        buf, off = self._buf, self._off
        while len(buf) - off >= 2:
            n, at = buf[off + 1] & 0x7F, off + 2
            if n == 126:
                if len(buf) - off < 4:
                    break
                n, at = struct.unpack_from(">H", buf, off + 2)[0], off + 4
            elif n == 127:
                if len(buf) - off < 10:
                    break
                n, at = struct.unpack_from(">Q", buf, off + 2)[0], off + 10
            if len(buf) < at + n:
                break
            # text frames (the hello) carry nothing the benchmark reads
            if buf[off] & 0x0F == 0x2 and n >= HEADER_BYTES:
                h = Header(*struct.unpack_from(HEADER_FMT, buf, at))
                if (self.keep_paused and self.paused_frame is None
                        and h.flags & FLAG_PAUSED):
                    self.paused_frame = bytes(buf[at:at + n])
                self.frames.append(Received(t, h))
            off = at + n
        if off == len(buf):
            buf.clear()
            off = 0
        elif off > (1 << 24):
            del buf[:off]
            off = 0
        self._off = off

    def _read(self, wait: float) -> None:
        ready, _, _ = select.select([self.sock], [], [], max(wait, 0.0))
        if ready:
            r = self.sock.recv_into(self._chunk)
            if r == 0:
                raise ConnectionError("server closed the stream")
            self._buf += self._chunk_view[:r]
            self._parse(time.perf_counter())

    def pump(self, until: float, sends: Sequence[tuple] = (),
             stop: Optional[Callable[[list], bool]] = None) -> bool:
        """Read frames until ``until`` (perf_counter), sending each
        (due, event) of ``sends`` at its due time; return True as soon as
        ``stop(frames)`` holds (False at ``until``)."""
        i = 0
        while True:
            if stop is not None and stop(self.frames):
                return True
            now = time.perf_counter()
            if i < len(sends) and now >= sends[i][0]:
                self.send(sends[i][1])
                self.late.append(time.perf_counter() - sends[i][0])
                i += 1
                continue
            nxt = sends[i][0] if i < len(sends) else until
            if now >= until and i >= len(sends):
                return False
            self._read(min(nxt, until) - now)

    # -- writing ----------------------------------------------------------------
    def send(self, event: dict) -> None:
        data = json.dumps(event).encode()
        n = len(data)
        head = bytes([0x81])
        if n < 126:
            head += bytes([0x80 | n])
        elif n < 1 << 16:
            head += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            head += bytes([0x80 | 127]) + struct.pack(">Q", n)
        # a zero masking key: the payload goes as it is, the frame is
        # still a masked client frame
        self.sock.sendall(head + b"\0\0\0\0" + data)

    def close(self) -> None:
        try:
            self.sock.sendall(b"\x88\x80\0\0\0\0")
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
