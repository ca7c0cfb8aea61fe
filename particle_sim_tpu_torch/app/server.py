"""Streaming server: the engine feeding a thin interactive browser client.

Counterpart of ``particle_sim_tpu/app/server.py``, with the same wire
protocol byte for byte, so the browser viewer works against either
server: the port serves its own copy (``app/viewer/``, the same files as
the JAX package's, byte for byte).

Stdlib only: a tiny HTTP server that serves the viewer page and upgrades
``/ws`` to a WebSocket (RFC 6455). One sim thread steps the engine; one
pack thread builds the newest frame; per-client writer threads push it
(latest wins: a slow client drops frames instead of stalling the sim).
While tracing is on (utils/trace.py) the sim thread's wait for the
engine lock, the frame's host work after the lock (fetch, header,
payload) and the frames built and sent are recorded.

Wire protocol (binary server->client):
    u32 magic 'PSIM' | u32 mode (0 planar-f32, 1 compact-f16, 2 raster)
    | u32 count | u32 frame_id | u32 total_particles | f32 fps
    | f32 update_ms | u32 reflected_seq | f32 input_to_frame_ms
    | u32 flags (bit 0: paused)
    | payload (mode 0: pos f32[3*count] then rgba u8[4*count];
               mode 1: 10-byte records — see io/packer.py;
               mode 2: u32 width | u32 height | rgba u8[4*width*height],
                       count = width*height, the frame rendered on the
                       device, so the wire cost is bound by the
                       resolution, not the particle count; the client
                       sends "camera" events instead of rendering.)
Client->server JSON events: params / mouse / pause / reset / resize /
method / generation / view / camera / solver. Events may carry a client
``seq``; ``reflected_seq`` is the newest event sequence whose effect the
frame's sim state includes, and ``input_to_frame_ms`` the server-side
event-arrival -> frame-built time for it.

Method names on the wire keep the protocol's vocabulary, which the shared
viewer's selector uses: "jnp" names the plain path (``Method.TORCH``) and
"pallas" the kernel path (``Method.CUDA``), the enums' values 0 and 1 in
both packages. The solver event switches self-gravity to the direct sum
("direct"), the per-frame particle mesh ("pm") or off ("off"). A "pm"
event may carry a refinement stack (``pm2_sizes`` with one
``pm2_softenings`` value a level, outermost first; [] clears it) and an
exact window (``pmx_size``, ``pmx_softening``, ``pmx_capacity``;
``pmx_size`` <= 0 clears it); absent fields keep what is installed. The
whole candidate solver is validated before any of it is committed: a bad
event is rejected with a logged warning and the running solver stays. A
"pm_persist" event is the "pm" event on the persistent cell-sorted state
(ops/pm_persist.py); with an exact window it needs a multi-level stack.
A "pm" event's ``two_tier`` field sets the engine's flag of that name
(the JAX package's persistent-PM repair strategy). The hello reports the
stack, the window, the flag and ``"solver": "pm_persist"`` when the
engine runs the persistent mode.

    python -m particle_sim_tpu_torch.app.server --device cuda --count 65536
    python -m particle_sim_tpu_torch.app.server --device cuda --pm \
        --count 1000000
    python -m particle_sim_tpu_torch.app.server --device cuda --count 1000000 \
        --pm2-size 32 8 --pm2-softening 0.75 0.25
    python -m particle_sim_tpu_torch.app.server --device cuda --count 4000000 \
        --pm-persist
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import socket
import struct
import threading
import time
from typing import Optional

import numpy as np

from ..core.params import (
    Method, PairwiseParams, PMConfig, SimParams, SphereGeneration,
)
from ..engine import Engine, available_methods
from ..io import packer
from ..ops import pm2 as pm2_ops
from ..ops import pm_persist
from ..ops import pmx as pmx_ops
from ..utils import trace
from ..render.camera import Camera

logger = logging.getLogger("particle_sim_tpu_torch.server")

MAGIC = 0x4D495350  # 'PSIM' little-endian
HEADER_FMT = "<IIIIIffIfI"   # see the wire-protocol docstring above
HEADER_BYTES = struct.calcsize(HEADER_FMT)  # 40
FLAG_PAUSED = 1 << 0
_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
#: The browser client (the port's copy of the viewer both servers share).
VIEWER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "viewer")
#: Wire name of each method (the protocol's vocabulary), and back.
WIRE_METHOD = {Method.TORCH: "jnp", Method.CUDA: "pallas"}
METHOD_BY_NAME = {name: m for m, name in WIRE_METHOD.items()}


# ---------------------------------------------------------------- WebSocket --
def _ws_accept_key(key: str) -> str:
    digest = hashlib.sha1((key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def ws_encode(payload: bytes, opcode: int = 0x2) -> bytes:
    """Server frame (unmasked): binary by default."""
    n = len(payload)
    head = bytes([0x80 | opcode])
    if n < 126:
        head += bytes([n])
    elif n < (1 << 16):
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


def ws_read_frame(sock: socket.socket) -> Optional[tuple]:
    """-> (opcode, payload) or None on close/EOF."""
    def recv_exact(k: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < k:
            chunk = sock.recv(k - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    head = recv_exact(2)
    if head is None:
        return None
    opcode = head[0] & 0x0F
    masked = head[1] & 0x80
    n = head[1] & 0x7F
    if n == 126:
        ext = recv_exact(2)
        if ext is None:
            return None
        n = struct.unpack(">H", ext)[0]
    elif n == 127:
        ext = recv_exact(8)
        if ext is None:
            return None
        n = struct.unpack(">Q", ext)[0]
    mask = recv_exact(4) if masked else b"\x00" * 4
    if mask is None:
        return None
    payload = recv_exact(n) if n else b""
    if payload is None:
        return None
    if masked:
        m = np.frombuffer((mask * ((n // 4) + 1))[:n], dtype=np.uint8)
        payload = (np.frombuffer(payload, dtype=np.uint8) ^ m).tobytes()
    if opcode == 0x8:  # close
        return None
    return opcode, payload


# ------------------------------------------------------------------- Server --
class StreamServer:
    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 8787, target_fps: float = 60.0):
        self.engine = engine
        self.host, self.port = host, port
        self.target_dt = 1.0 / target_fps
        self.params = SimParams()
        self.frame_id = 0
        self.latest: Optional[bytes] = None
        self.cond = threading.Condition()
        self.lock = threading.Lock()       # guards engine + params mutations
        self.max_points = 250_000
        self.wire_mode = 0                 # 0 planar f32, 1 compact f16,
        #                                    2 server-side raster (RGBA8)
        self.raster_size = (1280, 720)     # mode-2 framebuffer (w, h)
        self.camera = Camera(aspect=1280.0 / 720.0)  # mode-2 viewpoint
        self.running = False
        self._state_version = 0
        # input->frame latency bookkeeping (all under self.lock):
        self._event_seq = 0        # newest client event seq + arrival time
        self._event_t = 0.0
        self._reflected_seq = 0    # newest seq the sim state includes
        self._reflected_t = 0.0
        self._latency_seq = 0      # last seq a latency was computed for
        self._latency_ms = 0.0
        self._threads: list = []
        self._sock: Optional[socket.socket] = None

    # -- input events (client JSON -> engine mutations) ----------------------
    @staticmethod
    def _coerce_params(fields: dict) -> dict:
        """Validate client-supplied SimParams fields NOW: a bad value
        stored here would otherwise crash the sim/pack threads later (in
        SimParams.pack), silently freezing the stream for every client."""
        out = {}
        for k, v in fields.items():
            if k not in SimParams.__dataclass_fields__:
                continue
            if k == "mouse_position":
                x, y, z = v  # raises for wrong arity/non-iterables
                out[k] = (float(x), float(y), float(z))
            elif k == "is_mouse_dragging":
                out[k] = bool(v)
            elif k == "color_mode":
                out[k] = int(v)
            else:
                out[k] = float(v)
        return out

    def handle_event(self, ev: dict) -> None:
        t = ev.get("type")
        with self.lock:
            if "seq" in ev:
                try:
                    self._event_seq = int(ev["seq"])
                    self._event_t = time.perf_counter()
                except (TypeError, ValueError):
                    pass
            p = self.params
            if t == "params":
                self.params = p.replace(**self._coerce_params(ev))
            elif t == "mouse":
                x, y, z = ev["pos"]
                self.params = p.replace(
                    mouse_position=(float(x), float(y), float(z)),
                    is_mouse_dragging=bool(ev.get("dragging", False)))
            elif t == "pause":
                self.engine.set_paused(not self.engine.is_paused())
            elif t == "reset":
                self.engine.reset()
            elif t == "resize":
                self.engine.resize(int(ev["count"]))
            elif t == "generation":
                mode = (SphereGeneration.HOLLOW if ev["mode"] == "hollow"
                        else SphereGeneration.FILLED)
                self.engine.resize(self.engine.particle_count, mode)
            elif t == "method":
                try:
                    self.engine.set_method(
                        METHOD_BY_NAME[str(ev["name"]).lower()])
                except (KeyError, ValueError):
                    pass
            elif t == "view":
                self.max_points = int(ev.get("max_points", self.max_points))
                self.wire_mode = {"planar": 0, "compact": 1,
                                  "raster": 2}.get(
                    ev.get("mode", ""), self.wire_mode)
                if "width" in ev or "height" in ev:
                    w, h = self.raster_size
                    w = int(ev.get("width", w))
                    h = int(ev.get("height", h))
                    # clamp + snap to the raster tile grid: height down to
                    # the 8-row tile, width UP to the 128-lane tile (client
                    # canvas widths are almost never 128-aligned, and an
                    # unaligned frame cannot take the tiled renderers); the
                    # client letterboxes the at-most-127-px overshoot
                    w = -(-max(128, min(3840, w)) // 128) * 128
                    h = max(64, min(2160, h)) // 8 * 8
                    self.raster_size = (w, h)
                    self.camera.aspect = w / h
            elif t == "camera":
                # mode-2 viewpoint: the thin client owns the free-fly
                # camera math and ships the resulting pose; the server
                # only validates it
                def _f(v):
                    v = float(v)
                    if not np.isfinite(v):   # fail fast: a NaN pose would
                        raise ValueError(v)  # silently render black frames
                    return v

                # validate EVERY field before assigning ANY: an event with
                # a valid pos but a NaN yaw must not leave the pose
                # half-applied for later frames
                upd = {}
                if "pos" in ev:
                    x, y, z = ev["pos"]
                    upd["position"] = np.array([_f(x), _f(y), _f(z)])
                if "yaw" in ev:
                    upd["yaw"] = _f(ev["yaw"])
                if "pitch" in ev:
                    lim = np.pi / 2.0 - 0.01
                    upd["pitch"] = min(lim, max(-lim, _f(ev["pitch"])))
                if "fov" in ev:
                    upd["fov"] = min(np.pi * 2 / 3,
                                     max(np.pi / 18, _f(ev["fov"])))
                for k, v in upd.items():
                    setattr(self.camera, k, v)
            elif t == "solver":
                # runtime self-gravity switch: off / particle mesh / direct
                name = ev.get("name", "off")
                g = float(ev.get("g", 1.0))
                eps = float(ev.get("softening", 2.0))
                if name in ("pm", "pm_persist"):
                    self._apply_pm_solver_event(ev, g, eps,
                                                persist=name == "pm_persist")
                elif name == "direct":
                    self.engine.pm = None
                    self.engine.set_pmx(None)   # window first: set_pm2
                    self.engine.set_pm2(None)   # cross-checks the window
                    self.engine.pairwise = PairwiseParams(g, eps)
                else:
                    self.engine.pm = None
                    self.engine.set_pmx(None)
                    self.engine.set_pm2(None)
                    self.engine.pairwise = None
            # every event can change what the next frame shows (pause flag,
            # reset state, camera pose in raster mode, color mode, ...):
            # bump the version so the pack loop re-streams even while the
            # sim is paused (a paused engine stops bumping it in _sim_loop)
            self._state_version += 1

    def _apply_pm_solver_event(self, ev: dict, g: float, eps: float,
                               persist: bool) -> None:
        """Validate the whole candidate solver (coarse PM, refinement
        stack, exact window, ``persist``: the persistent PM) before
        committing any of it: a bad event is rejected with a warning and
        the running solver is kept."""
        eng = self.engine
        try:
            new_pm = PMConfig(softening=eps,
                              auto_box=bool(ev.get("auto_box", False)))
            stack = eng.pm2
            if "pm2_sizes" in ev:
                sizes = [float(x) for x in ev["pm2_sizes"]]
                softs = [float(x) for x in ev.get("pm2_softenings", [])]
                if len(softs) != len(sizes):
                    raise ValueError(
                        "pm2 size/softening lists differ in length")
                cand = tuple(pm2_ops.PM2Config(window_min=None,
                                               window_size=sz, softening=e)
                             for sz, e in zip(sizes, softs))
                stack = (None if not cand
                         else cand[0] if len(cand) == 1 else cand)
            window = eng.pmx
            if "pmx_size" in ev:
                size = float(ev["pmx_size"])
                window = None if size <= 0.0 else pmx_ops.PMXConfig(
                    window_size=size,
                    softening=float(ev.get("pmx_softening", 0.1)),
                    capacity=int(ev.get("pmx_capacity", 65536)))
            levels = pm2_ops.as_levels(stack)
            if levels:
                pm2_ops._validate_levels(new_pm, levels)
            if eng.mesh is not None and stack is not None and not persist:
                raise ValueError("multi-chip pm2 requires pm_persist")
            if window is not None:
                (pm_persist.validate if persist
                 else pmx_ops._validate)(new_pm, levels, window)
                if eng.mesh is not None and not isinstance(stack, tuple):
                    raise ValueError("multi-chip pmx needs a MULTI-level "
                                     "pm2 stack")
        except (TypeError, ValueError) as e:
            logger.warning("solver event rejected: %s (keeping the current "
                           "solver)", e)
            return
        # commit: pm first so set_pm2 / set_pmx validate against it; the
        # window is cleared around the stack swap so their cross-checks
        # never see an old/new mix
        eng.pm = new_pm
        eng.pairwise = PairwiseParams(g, eps)
        eng.pm_persist = persist
        eng.set_pmx(None)
        eng.set_pm2(stack)
        eng.set_pmx(window)
        if "two_tier" in ev:
            # the JAX package's persistent-PM repair strategy (the JAX
            # server sets it from the same field)
            eng.two_tier = bool(ev["two_tier"])

    # -- frame production -----------------------------------------------------
    def _build_frame(self) -> bytes:
        # queue the device-side pack under the lock (orders it against the
        # in-place steps), fetch to the host outside it so the sim thread
        # never waits on the transfer
        with self.lock:
            mode = self.wire_mode  # read once: header must match payload
            if mode == 2:
                w, h = self.raster_size
                fb_dev = self.engine.render_frame_device(
                    self.camera, self.params, width=w, height=h)
            else:
                pos_dev, rgba_dev = self.engine.frame_arrays_device(
                    self.params, self.max_points)
            total = self.engine.particle_count
            stats = self.engine.stats
            paused = self.engine.is_paused()
            rseq, rt = self._reflected_seq, self._reflected_t
        with trace.span("server.frame_host"):
            if mode == 2:
                fb = fb_dev.cpu().numpy()        # fetch outside the lock
            else:
                pos = np.ascontiguousarray(pos_dev.cpu().numpy())
                rgba = np.ascontiguousarray(rgba_dev.cpu().numpy())
            if rseq > self._latency_seq:
                # first frame reflecting event rseq: freeze its end-to-end
                # server latency (arrival -> payload fetched); later frames
                # re-report the same number instead of a growing stale one
                self._latency_seq = rseq
                self._latency_ms = (time.perf_counter() - rt) * 1e3
            if mode == 2:
                h, w = fb.shape[0], fb.shape[1]
                count = w * h
                payload = struct.pack("<II", w, h) + fb.tobytes()
            elif mode == 1:
                payload = packer.pack_f16(pos, rgba).tobytes()
                count = len(payload) // packer.RECORD_BYTES
            else:
                count = pos.shape[1]
                payload = pos.tobytes() + rgba.tobytes()
            head = struct.pack(
                HEADER_FMT, MAGIC, mode, count, self.frame_id,
                total, float(stats.fps), float(stats.update_ms),
                rseq, float(self._latency_ms),
                FLAG_PAUSED if paused else 0)
            return head + payload

    def _sim_loop(self) -> None:
        while self.running:
            trace.refresh()
            t0 = time.perf_counter()
            with trace.span("server.lock_wait"):
                self.lock.acquire()
            try:
                stepped = not self.engine.is_paused()
                seq, seq_t = self._event_seq, self._event_t
                self.engine.step(self.params)
                if stepped:
                    # this step consumed every event up to seq: frames
                    # packed from it reflect that input
                    self._reflected_seq, self._reflected_t = seq, seq_t
            finally:
                self.lock.release()
            if stepped:
                # paused frames are identical: don't re-pack/re-stream them
                self._state_version += 1
            # sleep at least a little even when the step outlasted the frame
            # budget (a particle-mesh step on the CPU takes ~1 s): the lock
            # is not fair, and an immediate re-acquire would starve the
            # event, hello and pack threads
            elapsed = time.perf_counter() - t0
            time.sleep(max(self.target_dt - elapsed, 1e-3))

    def _pack_loop(self) -> None:
        """Builds outgoing frames from the newest state, decoupled from the
        sim cadence (frame fetch/pack never stalls stepping)."""
        packed_version = -1
        while self.running:
            trace.refresh()
            if self._state_version == packed_version:
                time.sleep(0.002)
                continue
            packed_version = self._state_version
            frame = self._build_frame()
            trace.count("server.frames_built")
            with self.cond:
                self.latest = frame
                self.frame_id += 1
                self.cond.notify_all()

    # -- client handling ------------------------------------------------------
    def _client_writer(self, sock: socket.socket) -> None:
        last_sent = -1
        try:
            while self.running:
                with self.cond:
                    self.cond.wait_for(
                        lambda: self.frame_id != last_sent or not self.running,
                        timeout=1.0)
                    fresh = self.frame_id != last_sent   # not a resend
                    frame, last_sent = self.latest, self.frame_id
                if frame is not None:
                    sock.sendall(ws_encode(frame))
                    if fresh:
                        trace.count("server.frames_sent")
        except OSError:
            pass

    def _client_reader(self, sock: socket.socket) -> None:
        try:
            while self.running:
                got = ws_read_frame(sock)
                if got is None:
                    break
                opcode, payload = got
                if opcode == 0x9:  # ping -> pong
                    sock.sendall(ws_encode(payload, opcode=0xA))
                elif opcode == 0x1:
                    try:
                        ev = json.loads(payload.decode())
                        if isinstance(ev, dict):
                            self.handle_event(ev)
                    except Exception:
                        # a malformed client event must never kill the
                        # reader thread; log it and keep reading
                        logger.warning("client event dropped",
                                       exc_info=True)
        except OSError:
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def hello(self) -> dict:
        """The capability message sent on connect: methods, count, pause
        flag, the solver state and the wire mode, so the panel reflects
        the server's state."""
        eng = self.engine
        pw = eng.pairwise
        solver = (("pm_persist" if eng.persist_resolved() else "pm")
                  if eng.pm is not None else "direct" if pw else "off")
        return {
            "type": "hello",
            "methods": [WIRE_METHOD[m] for m in available_methods(eng.device)],
            "method": WIRE_METHOD[eng.method],
            "count": eng.particle_count,
            "paused": eng.is_paused(),
            "solver": solver,
            "solver_g": pw.gravitational_constant if pw else 1.0,
            "solver_softening": (eng.pm.softening if eng.pm is not None
                                 else pw.softening if pw else 2.0),
            # the refinement stack (outermost first; [] = none) and the
            # exact window (0 = none), so the panel reflects them
            "pm2_sizes": [c.window_size
                          for c in pm2_ops.as_levels(eng.pm2)],
            "pm2_softenings": [c.softening
                               for c in pm2_ops.as_levels(eng.pm2)],
            "pmx_size": eng.pmx.window_size if eng.pmx else 0,
            "pmx_softening": eng.pmx.softening if eng.pmx else 0,
            "two_tier": bool(eng.two_tier),
            "wire_mode": {0: "planar", 1: "compact",
                          2: "raster"}[self.wire_mode],
            "raster_size": list(self.raster_size),
        }

    def _serve_static(self, sock: socket.socket, path: str) -> None:
        """Serve the viewer shell (whitelisted static files)."""
        static = {
            "/": ("index.html", "text/html"),
            "/index.html": ("index.html", "text/html"),
            "/manifest.json": ("manifest.json", "application/json"),
            "/sw.js": ("sw.js", "application/javascript"),
        }
        for icon in ("icon-1024.png", "icon-256.png",
                     "icon_ios_touch_192.png", "maskable_icon_x512.png",
                     "favicon.png"):
            static[f"/assets/{icon}"] = (os.path.join("assets", icon),
                                         "image/png")
        entry = static.get(path.split("?")[0])
        try:
            if entry is None:
                raise FileNotFoundError(path)
            fname, ctype = entry
            with open(os.path.join(VIEWER_DIR, fname), "rb") as f:
                body = f.read()
            cache = "max-age=86400" if ctype == "image/png" else "no-cache"
            sock.sendall(
                f"HTTP/1.1 200 OK\r\nContent-Type: {ctype}\r\n"
                f"Cache-Control: {cache}\r\n"
                f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        except OSError:   # FileNotFoundError included
            sock.sendall(b"HTTP/1.1 404 Not Found\r\n\r\n")
        sock.close()

    def _handle_conn(self, sock: socket.socket) -> None:
        try:
            sock.settimeout(5.0)
            req = b""
            while b"\r\n\r\n" not in req:
                chunk = sock.recv(4096)
                if not chunk:
                    return
                req += chunk
            head = req.decode("latin-1")
            lines = head.split("\r\n")
            path = lines[0].split(" ")[1] if " " in lines[0] else "/"
            headers = {}
            for line in lines[1:]:
                if ": " in line:
                    k, v = line.split(": ", 1)
                    headers[k.lower()] = v

            if "sec-websocket-key" in headers and path.startswith("/ws"):
                accept = _ws_accept_key(headers["sec-websocket-key"])
                sock.sendall((
                    "HTTP/1.1 101 Switching Protocols\r\n"
                    "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                    f"Sec-WebSocket-Accept: {accept}\r\n\r\n"
                ).encode())
                sock.settimeout(None)
                with self.lock:
                    hello = json.dumps(self.hello())
                sock.sendall(ws_encode(hello.encode(), opcode=0x1))
                w = threading.Thread(target=self._client_writer, args=(sock,),
                                     daemon=True)
                w.start()
                self._client_reader(sock)
            else:
                self._serve_static(sock, path)
        except OSError:
            pass

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        """Bind, listen and start the sim, pack and accept threads. With
        ``port=0`` the system picks a free port; ``self.port`` then holds
        it."""
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(8)
        self.running = True
        for target in (self._sim_loop, self._pack_loop, self._accept_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def _accept_loop(self) -> None:
        while self.running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            t = threading.Thread(target=self._handle_conn, args=(conn,),
                                 daemon=True)
            t.start()

    def stop(self) -> None:
        self.running = False
        with self.cond:
            self.cond.notify_all()
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        # bounded join: an in-flight step must not straggle into whatever
        # runs next
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(10.0)

    def serve_forever(self) -> None:
        self.start()
        print(f"viewer: http://{self.host}:{self.port}/  "
              f"(ws on /ws, {self.engine.particle_count} particles, "
              f"method {self.engine.method.name}, device "
              f"{self.engine.device})")
        try:
            while True:
                time.sleep(1.0)
        except KeyboardInterrupt:
            self.stop()


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(
        prog="particle_sim_tpu_torch.app.server",
        description="particle_sim_tpu_torch stream server")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device of the state; 'cuda' never falls back")
    ap.add_argument("--count", type=int, default=None)
    ap.add_argument("--method", choices=["auto", "torch", "cuda"],
                    default="auto")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--fps", type=float, default=60.0)
    ap.add_argument("--max-points", type=int, default=250_000)
    ap.add_argument("--view-mode", choices=["planar", "compact", "raster"],
                    default="planar",
                    help="wire mode: stream points (planar/compact) or "
                    "render on the device and stream the framebuffer "
                    "(raster: wire cost bound by the resolution)")
    ap.add_argument("--raster-size", default="1280x720",
                    help="raster-mode framebuffer, WxH (snapped to the "
                    "128x8 tile grid)")
    ap.add_argument("--pm", action="store_true",
                    help="self-gravity by the particle-mesh solver")
    ap.add_argument("--pm-g", type=float, default=1.0)
    ap.add_argument("--pm-softening", type=float, default=2.0)
    ap.add_argument("--no-two-tier", action="store_true",
                    help="the JAX package's persistent-PM repair strategy: "
                    "full sort only (kept on the engine; every repair of the "
                    "port is the full sort)")
    ap.add_argument("--pm2-size", type=float, nargs="+", default=[0.0],
                    help="refinement-window extent(s), outermost first "
                    "(several values nest levels); implies --pm")
    ap.add_argument("--pm2-softening", type=float, nargs="+",
                    default=[0.5], help="fine softening, one a --pm2-size "
                    "value")
    ap.add_argument("--pm-persist", action="store_true",
                    help="the persistent cell-sorted PM state (implies --pm)")
    return ap


def make_server(argv=None) -> StreamServer:
    """Parse the flags and build the server (not started)."""
    import re

    ap = build_parser()
    args = ap.parse_args(argv)
    m = re.fullmatch(r"(\d+)x(\d+)", args.raster_size.strip().lower())
    if m is None:
        ap.error(f"--raster-size must be WxH (got {args.raster_size!r})")
    method = {"auto": None, "torch": Method.TORCH,
              "cuda": Method.CUDA}[args.method]
    want_pm = args.pm or args.pm_persist or args.pm2_size[0] > 0.0
    pm2_cfg = None
    if args.pm2_size[0] > 0.0:
        sizes, softs = args.pm2_size, args.pm2_softening
        if len(softs) != len(sizes):
            ap.error("--pm2-softening needs one value per --pm2-size")
        levels = tuple(pm2_ops.PM2Config(window_min=None, window_size=sz,
                                         softening=e)
                       for sz, e in zip(sizes, softs))
        pm2_cfg = levels if len(levels) > 1 else levels[0]
    engine = Engine(
        particle_count=args.count, method=method, device=args.device,
        pm=PMConfig(softening=args.pm_softening) if want_pm else None,
        pairwise=(PairwiseParams(args.pm_g, args.pm_softening)
                  if want_pm else None),
        pm2=pm2_cfg,
        # bare --pm keeps "auto": Engine.PERSIST_AUTO_MIN_N decides
        pm_persist=True if args.pm_persist else "auto",
        two_tier=not args.no_two_tier)
    server = StreamServer(engine, host=args.host, port=args.port,
                          target_fps=args.fps)
    server.max_points = args.max_points
    server.handle_event({"type": "view", "mode": args.view_mode,
                         "width": int(m.group(1)), "height": int(m.group(2))})
    return server


def main(argv=None) -> int:
    make_server(argv).serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
