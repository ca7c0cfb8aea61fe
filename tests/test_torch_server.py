"""The port's stream server (app/server.py) and frame packer (io/packer.py)
on the CPU: the wire protocol against the JAX package's server, the
events, and the packer's two paths (loopback sockets, no browser)."""

import base64
import hashlib
import json
import logging
import socket
import struct
import time

import numpy as np
import pytest
import torch

from particle_sim_tpu.app import server as jserver
from particle_sim_tpu.core.params import Method as JMethod
from particle_sim_tpu.core.state import ParticleState as JState
from particle_sim_tpu.engine import Engine as JEngine
from particle_sim_tpu.io import packer as jpacker

from particle_sim_tpu_torch.app import server
from particle_sim_tpu_torch.core import generate as gen
from particle_sim_tpu_torch.core.params import Method, PairwiseParams
from particle_sim_tpu_torch.core.state import ParticleState
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.io import packer

torch.set_num_threads(1)

HDR = server.HEADER_BYTES
N = 2000
WAIT_S = 20.0   # every wait below gives up after this long


# ---------------------------------------------------------------- ws client --
class WsClient:
    """Minimal client: handshake, masked text frames out, frames in; every
    read has a socket timeout."""

    def __init__(self, port, timeout=WAIT_S):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=timeout)
        key = base64.b64encode(b"0123456789abcdef").decode()
        self.sock.sendall((
            "GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self.sock.recv(4096)
            assert chunk, "connection closed during the handshake"
            resp += chunk
        head, _, self.buf = resp.partition(b"\r\n\r\n")
        assert b"101" in head.split(b"\r\n")[0]
        expect = base64.b64encode(hashlib.sha1(
            (key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()).digest())
        assert expect in head

    def _exact(self, k):
        while len(self.buf) < k:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("eof")
            self.buf += chunk
        out, self.buf = self.buf[:k], self.buf[k:]
        return out

    def frame(self):
        head = self._exact(2)
        n = head[1] & 0x7F
        if n == 126:
            n = struct.unpack(">H", self._exact(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", self._exact(8))[0]
        return head[0] & 0x0F, self._exact(n)

    def binary(self):
        while True:
            op, payload = self.frame()
            if op == 0x2:
                return payload

    def text(self):
        while True:
            op, payload = self.frame()
            if op == 0x1:
                return json.loads(payload.decode())

    def send(self, obj):
        payload = json.dumps(obj).encode()
        assert len(payload) < 126
        mask = b"\x11\x22\x33\x44"
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        self.sock.sendall(bytes([0x81, 0x80 | len(payload)]) + mask + masked)

    def close(self):
        self.sock.close()


def header(frame):
    return struct.unpack(server.HEADER_FMT, frame[:HDR])


def wait_for_frame(client, pred):
    """Next binary frame satisfying pred, within WAIT_S."""
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        frame = client.binary()
        if pred(frame):
            return frame
    raise AssertionError("no matching frame before the deadline")


def http_get(port, path):
    s = socket.create_connection(("127.0.0.1", port), timeout=WAIT_S)
    s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    resp = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        resp += chunk
    s.close()
    return resp


@pytest.fixture
def srv():
    engine = Engine(particle_count=N, device="cpu", method=Method.TORCH)
    s = server.StreamServer(engine, port=0, target_fps=30)
    s.start()
    yield s
    s.stop()


# -------------------------------------------------------------------- HTTP --
@pytest.mark.parametrize("path,marker", [
    ("/", b"particle-sim-tpu"), ("/manifest.json", b"maskable"),
    ("/sw.js", b"psim-tpu-v1"), ("/assets/favicon.png", b"\x89PNG"),
    ("/nope", b"404")])
def test_http_serves_viewer(srv, path, marker):
    resp = http_get(srv.port, path)
    assert marker in resp
    if marker != b"404":
        assert resp.startswith(b"HTTP/1.1 200 OK")


def test_viewer_is_the_jax_packages_file():
    with open(f"{server.VIEWER_DIR}/index.html", "rb") as f:
        ours = f.read()
    with open(jserver._VIEWER_PATH, "rb") as f:
        assert f.read() == ours


def test_hello_capabilities(srv):
    c = WsClient(srv.port)
    hello = c.text()
    c.close()
    assert hello["type"] == "hello"
    assert hello["methods"] == ["jnp"] and hello["method"] == "jnp"
    assert hello["count"] == N and hello["paused"] is False
    assert hello["solver"] == "off" and hello["two_tier"] is True
    assert hello["wire_mode"] == "planar"
    assert hello["raster_size"] == [1280, 720]
    assert hello["pm2_sizes"] == [] and hello["pmx_size"] == 0


# ----------------------------------------------------------------- frames --
def test_frames_in_modes_0_1_2(srv):
    c = WsClient(srv.port)
    frame = c.binary()
    magic, mode, count, _, total, _, _, _, _, flags = header(frame)
    assert (magic, mode, total, flags) == (server.MAGIC, 0, N, 0)
    assert len(frame) == HDR + 16 * count
    pos = np.frombuffer(frame, np.float32, 3 * count, HDR).reshape(3, -1)
    rgba = np.frombuffer(frame, np.uint8, 4 * count,
                         HDR + 12 * count).reshape(-1, 4)
    radii = np.sqrt((pos[:, :total] ** 2).sum(0))
    assert abs(np.median(radii) - 50.0) < 2.0      # hollow sphere
    assert (rgba[:total, 3] == 255).all()

    c.send({"type": "view", "mode": "compact"})
    frame = wait_for_frame(c, lambda f: header(f)[1] == 1)
    count = header(frame)[2]
    assert len(frame) == HDR + count * packer.RECORD_BYTES
    p16, c16 = packer.unpack_f16(np.frombuffer(frame, np.uint8, offset=HDR))
    assert abs(np.median(np.linalg.norm(p16[c16[:, 3] > 0], axis=1))
               - 50.0) < 2.0

    # gravity makes the points move, and so lights them (min(2|v|, 1))
    c.send({"type": "params", "gravity": 5.0})
    c.send({"type": "view", "mode": "raster", "width": 70, "height": 67})
    frame = wait_for_frame(
        c, lambda f: header(f)[1] == 2 and np.frombuffer(
            f, np.uint8, offset=HDR + 8)[:].reshape(-1, 4)[:, :3].max() > 0)
    w, h = struct.unpack("<II", frame[HDR:HDR + 8])
    assert (w, h) == (128, 64)        # width up to 128, height down to 8
    assert header(frame)[2] == w * h
    assert len(frame) == HDR + 8 + 4 * w * h

    c.send({"type": "view", "mode": "planar"})
    wait_for_frame(c, lambda f: header(f)[1] == 0)
    c.close()


def test_first_frame_matches_jax_server():
    """Both servers on paused engines holding the same state: the first
    mode-0 payload has the same header fields and the same position
    bytes, and rgba within one u8 level."""
    pos, _, col = gen.generate(N)
    vel = np.random.default_rng(7).normal(size=pos.shape).astype(np.float32)
    je = JEngine(particle_count=N, method=JMethod.JNP)
    je.state = JState.from_arrays(pos, vel, col)
    te = Engine(particle_count=N, device="cpu")
    te.state = ParticleState.from_arrays(pos, vel, col, device="cpu")
    js = jserver.StreamServer(je, port=0, target_fps=30)
    ts = server.StreamServer(te, port=0, target_fps=30)
    frames = []
    for s, start in ((js, _start_jax_server), (ts, server.StreamServer.start)):
        s.engine.set_paused(True)
        s.handle_event({"type": "params", "color_mode": 1})
        start(s)
        try:
            c = WsClient(s.port)
            frames.append(c.binary())
            c.close()
        finally:
            # wake the accept loop first: close() alone leaves accept()
            # blocked, and stop() would wait out its join limit
            s._sock.shutdown(socket.SHUT_RDWR)
            s.stop()
    jf, tf = frames
    assert header(tf)[1:3] == header(jf)[1:3]          # mode, count
    assert header(tf)[4] == header(jf)[4] == N          # total
    assert header(tf)[9] == header(jf)[9] == server.FLAG_PAUSED
    count = header(tf)[2]
    assert len(tf) == len(jf) == HDR + 16 * count
    assert tf[HDR:HDR + 12 * count] == jf[HDR:HDR + 12 * count]
    trgba = np.frombuffer(tf, np.uint8, offset=HDR + 12 * count)
    jrgba = np.frombuffer(jf, np.uint8, offset=HDR + 12 * count)
    assert np.abs(trgba.astype(np.int16) - jrgba.astype(np.int16)).max() <= 1
    assert trgba.reshape(-1, 4)[:, :3].max() > 0        # not vacuous


def _start_jax_server(s):
    """The JAX server binds the port it is given: bind an ephemeral one
    first, as tests/test_stream.py's fixture does."""
    import threading

    s._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s._sock.bind(("127.0.0.1", 0))
    s.port = s._sock.getsockname()[1]
    s._sock.listen(8)
    s.running = True
    for target in (s._sim_loop, s._pack_loop, s._accept_loop):
        t = threading.Thread(target=target, daemon=True)
        t.start()
        s._threads.append(t)


# ----------------------------------------------------------------- events --
def test_solver_event_reflected_over_the_wire(srv):
    """A "direct" solver event with a seq switches the engine to the
    direct sum; a later frame reflects the seq (reflected_seq advances)
    with a plausible server latency."""
    c = WsClient(srv.port)
    c.binary()
    c.send({"type": "solver", "name": "direct", "g": 0.5, "softening": 0.7,
            "seq": 7})
    frame = wait_for_frame(c, lambda f: header(f)[7] >= 7)
    assert header(frame)[7] == 7 and header(frame)[8] > 0.0
    assert srv.engine.pairwise == PairwiseParams(0.5, 0.7)
    c.send({"type": "mouse", "pos": [1, 2, 3], "dragging": True, "seq": 8})
    frame = wait_for_frame(c, lambda f: header(f)[7] >= 8)
    assert header(frame)[7] == 8
    assert srv.params.mouse_position == (1.0, 2.0, 3.0)
    c.close()


def test_solver_events_switch_pairwise(caplog):
    srv = server.StreamServer(Engine(particle_count=1000, device="cpu"),
                              port=0)
    eng = srv.engine
    assert eng.pairwise is None
    srv.handle_event({"type": "solver", "name": "direct", "g": 2.0,
                      "softening": 0.3})
    assert eng.pairwise == PairwiseParams(2.0, 0.3)
    assert srv.hello()["solver"] == "direct"
    # the particle-mesh solvers are not ported: rejected, solver kept
    with caplog.at_level(logging.WARNING, logger=server.logger.name):
        srv.handle_event({"type": "solver", "name": "pm", "g": 1.0,
                          "softening": 3.0})
        srv.handle_event({"type": "solver", "name": "pm_persist"})
    assert eng.pairwise == PairwiseParams(2.0, 0.3)
    assert sum("ROADMAP.md" in r.getMessage() for r in caplog.records) == 2
    srv.handle_event({"type": "solver", "name": "off"})
    assert eng.pairwise is None and srv.hello()["solver"] == "off"


def test_camera_event_rejects_non_finite_whole():
    srv = server.StreamServer(Engine(particle_count=1000, device="cpu"),
                              port=0)
    pos0, yaw0 = srv.camera.position.copy(), srv.camera.yaw
    for ev in ({"type": "camera", "pos": [1.0, 2.0, 3.0],
                "yaw": float("nan")},
               {"type": "camera", "pos": [0.0, float("inf"), 0.0]},
               {"type": "camera", "fov": "wide"}):
        with pytest.raises(ValueError):
            srv.handle_event(ev)
    np.testing.assert_array_equal(srv.camera.position, pos0)
    assert srv.camera.yaw == yaw0
    srv.handle_event({"type": "camera", "pos": [0, 0, 300.0], "fov": 9.0})
    assert srv.camera.position[2] == 300.0
    assert srv.camera.fov == pytest.approx(np.pi * 2 / 3)   # clamped


@pytest.mark.parametrize("w,h,want", [
    (70, 67, (128, 64)), (1281, 721, (1408, 720)), (9999, 9999, (3840, 2160)),
    (1, 1, (128, 64))])
def test_raster_size_snaps_to_tiles(w, h, want):
    srv = server.StreamServer(Engine(particle_count=1000, device="cpu"),
                              port=0)
    srv.handle_event({"type": "view", "width": w, "height": h})
    assert srv.raster_size == want
    assert srv.camera.aspect == want[0] / want[1]


def test_bad_params_event_fails_fast():
    srv = server.StreamServer(Engine(particle_count=1000, device="cpu"),
                              port=0)
    before = srv.params
    for ev in ({"type": "params", "delta_time": "fast"},
               {"type": "params", "mouse_position": [1, 2]},
               {"type": "mouse", "pos": 5}):
        with pytest.raises((ValueError, TypeError)):
            srv.handle_event(ev)
    assert srv.params == before
    srv.params.pack()


def test_lifecycle_events():
    srv = server.StreamServer(Engine(particle_count=1000, device="cpu"),
                              port=0)
    eng = srv.engine
    srv.handle_event({"type": "pause"})
    assert eng.is_paused()
    srv.handle_event({"type": "resize", "count": 500})
    assert eng.particle_count == 500
    srv.handle_event({"type": "generation", "mode": "filled"})
    assert int(eng.generation_mode) == 1 and eng.particle_count == 500
    srv.handle_event({"type": "method", "name": "jnp"})
    srv.handle_event({"type": "method", "name": "pallas"})   # no CUDA: kept
    srv.handle_event({"type": "method", "name": "nope"})     # unknown: kept
    assert eng.method == Method.TORCH
    srv.handle_event({"type": "reset"})
    assert eng.particle_count == 500 and eng.is_paused()


def test_make_server_flags():
    s = server.make_server(["--device", "cpu", "--count", "1024",
                            "--view-mode", "raster", "--raster-size",
                            "300x200", "--max-points", "777"])
    assert s.wire_mode == 2 and s.raster_size == (384, 200)
    assert s.max_points == 777 and s.engine.particle_count == 1024
    assert s.engine.device.type == "cpu"
    for flags in (["--pm"], ["--pm-persist"], ["--pm2-size", "24"]):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            server.make_server(["--device", "cpu", *flags])


def test_wire_constants_match_jax():
    assert server.HEADER_FMT == jserver.HEADER_FMT
    assert server.HEADER_BYTES == jserver.HEADER_BYTES == 40
    assert server.MAGIC == jserver.MAGIC
    assert server.FLAG_PAUSED == jserver.FLAG_PAUSED
    for n in (5, 200, 70000):
        assert server.ws_encode(b"x" * n) == jserver.ws_encode(b"x" * n)


# ----------------------------------------------------------------- packer --
@pytest.fixture
def planes():
    rng = np.random.default_rng(3)
    pos = (rng.normal(size=(3, 5000)) * 50).astype(np.float32)
    pos[:, :4] = [[np.nan, np.inf, -0.0, 7e4]] * 3   # edge values (7e4
    #                                                  overflows binary16)
    return pos, rng.integers(0, 256, (5000, 4), dtype=np.uint8)


@pytest.mark.filterwarnings("ignore:overflow encountered in cast")
@pytest.mark.parametrize("stride", [1, 2, 7])
def test_packer_native_matches_numpy_and_jax(planes, stride, monkeypatch):
    pos, rgba = planes
    assert packer.have_native()
    a = packer.pack_f16(pos, rgba, stride=stride)
    ap, ac = packer.pack_planar_f32(pos, rgba, stride=stride)
    monkeypatch.setattr(packer, "_lib", None)
    b = packer.pack_f16(pos, rgba, stride=stride)
    bp, bc = packer.pack_planar_f32(pos, rgba, stride=stride)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ap, bp)
    np.testing.assert_array_equal(ac, bc)
    np.testing.assert_array_equal(a, jpacker.pack_f16(pos, rgba,
                                                      stride=stride))
    np.testing.assert_array_equal(ap, pos[:, ::stride])
    np.testing.assert_array_equal(ac, rgba[::stride])


def test_packer_f16_roundtrip(planes):
    pos, rgba = planes
    pos = pos[:, 4:]
    rgba = rgba[4:]
    p, c = packer.unpack_f16(packer.pack_f16(pos, rgba))
    np.testing.assert_array_equal(c, rgba)
    rel = np.abs(p - pos.T) / (1.0 + np.abs(pos.T))
    assert rel.max() < 6e-4     # binary16: relative 2^-11


def test_packer_rejects_mismatched_shapes(planes):
    pos, rgba = planes
    with pytest.raises(ValueError):
        packer.pack_f16(pos, rgba[:-1])
    with pytest.raises(ValueError):
        packer.pack_planar_f32(pos[:2], rgba)
