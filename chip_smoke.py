#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (particle_sim_tpu_torch) on one
NVIDIA GPU: builds the hand-written kernels, holds each against its plain
PyTorch version, drives the headless CLI at 1M particles (the attractor),
at 65,536 (direct-sum gravity) and at 1M (particle-mesh gravity), drives
the WebSocket server at 65,536, and times the kernels.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases (each prints a line; any failure raises and exits non-zero):
  1. build the CUDA kernels of particle_sim_tpu_torch/csrc/ with nvcc
  2. step kernel vs plain PyTorch at 1M and 16,777,216 particles, three
     parameter sets, 1 and 5 substeps (rtol = atol = 1e-6 for one step,
     1e-5 for five)
  3. compaction kernel (bit-exact) and deposit kernel (|k - p| <= 1e-5 +
     1e-4 |p|: f32 sums in atomic order) vs their plain versions, at 1M
     particles @ 1280x720 and 16M @ 1920x1080, default camera; the whole
     frame through the kernels within one u8 level of the plain pipeline;
     the golden frame (tests/data/golden_raster_256x128.npz) through the
     kernels within 3 u8 levels
  4. the main path: particle_sim_tpu_torch.app.cli.main at 1M particles,
     600 steps, orbiting dragged attractor, a 1280x720 frame every 100
     steps; checks the frames, the final state and the kernel launch counts
  5. times with CUDA events (medians after warm-up) of the step,
     compaction and deposit kernels beside their plain versions, the one
     PyTorch call that computes the same function (where there is one) and
     the bound (the least time the card could take); the kernel-level
     times queue the calls behind a GPU spin, so they are device times
  6. pairwise kernel vs plain at 65,536 (G = 1, eps 0.5, filled sphere):
     the full square, 60,000 active with poisoned padding, a central mass
     of 1000, and Ni = 65,536 x Nj = 32,768 at j_base = 32,768; bar
     max|k - p| <= 1e-4 max|p| per component (f32 sums in another order);
     one direct-sum step (kernel, plain kick, step kernel) vs the plain step
  7. sorted-deposit kernel vs plain at 1M @ 1280x720 and 16M @ 1920x1080
     (|k - p| <= 1e-5 + 1e-4 |p| on raw tile sums); the whole frame within
     one u8 level of the plain pipeline; the golden frame through the
     kernel within 3 u8 levels
  8. the gravity main path: particle_sim_tpu_torch.app.cli.main with
     --pairwise --central-mass 1000 at 65,536 particles, 200 steps, a
     sorted 1280x720 frame every 100 steps; checks the launch counts, the
     frames, a finite final state, the masses, and that the total momentum
     stays 0 and the centre of mass in place; then the sorted-deposit
     kernel vs plain (phase 7's bars) on the CLI's final state at the
     path's own shape, 65,536 @ 1280x720
  9. the WebSocket server at 65,536 in-process on an ephemeral port: a
     "direct" solver event, then frames in wire modes 0, 1 and 2, then a
     "pm" solver event; checks the headers, reflected_seq, the status
     ("solver": "pm") and the launch counts (the PM kernels' included);
     then the compaction and deposit kernels vs plain (phase 3's bars) on
     the server's state, parameters and camera at its shape, 65,536 @
     1280x720 (its PM deposit and gather follow in phase 11)
 10. times: pairwise at 65,536 and the sorted deposit at 1M and 16M beside
     their plain versions, library call and bound (for the pairwise sum
     the largest of its FP32 issue, flop and rsqrt bounds, beside the
     FP32 instructions a pair in the kernel's SASS); the sorted, compact
     and scatter frames (these include the host: the compact frame reads
     one count back per frame)
 11. particle-mesh deposit and gather kernels vs plain at 1M (hollow
     sphere, static box): G = 128 isolated with unit masses and with
     masses, G = 128 periodic with a fifth of the particles outside the
     box, G = 32, G = 96 (not a grid of the TPU kernels) and G = 256
     (deposit |k - p| <= 1e-5 max|p|: f32 sums in atomic order; gather <=
     1e-6 max|p|); pm_accel through the kernels vs the plain pm_accel_ref
     (<= 1e-4 max|a|; padding 0) in those five and auto_box with masses;
     the deposit and gather on phase 9's server state after its "pm"
     event (65,536, G = 128); PM (G = 128, eps 5) vs the pairwise kernel
     at 65,536 (filled sphere): rms relative error < 0.05
 12. the PM main path through the CLI at 1M: (a) the documented command
     --pm --pm-auto-box --pairwise-g 0.08 --dt 0.004 --diagnostics, 600
     steps; (b) --pm --central-mass 1000 --renderer sorted, 200 steps, a
     frame every 100; checks the launch counts (deposit = gather = step =
     steps, the mass deposit in (b); in (a) each diagnostics line adds a
     deposit and a gather, the mesh potential's), a finite final state,
     momentum 0 and the centre of mass in place, the diagnostics lines,
     the frames; then deposit and gather vs plain on (b)'s final state
     (the cloud after its collapse, much of it clamped onto the box's
     faces): the deposit against a float64 sum of the same f32 corner
     weights, within K u |p| for a cell of K contributions (the f32
     summation bound), the gather within 1e-6 max|p|
 13. times: the PM deposit and gather kernels at 1M and 16,777,216 (G =
     128, static box) and on (b)'s final state, beside their plain
     versions, a library call (index_put_ of the 8N corner weights;
     grid_sample, trilinear) and the bytes bound; the PM step's layers
     (deposit, FFT solve, gather, momentum_clean, kick + step, the whole
     step) and torch.sort of N int32 cell keys (the sort the TPU design
     pays)
 14. the tensor-core all-pairs force (pairwise_cuda.pairwise_accel_mxu, no
     entry point calls it) at 65,536 (filled sphere, G = 2.5, eps 0.5):
     the square, 60,000 active with poisoned padding, 65,536 x 32,768 at
     j_base 32,768, 32,768 x 65,536 and 1,000 x 777 with 700 active;
     against its plain version (within twice the plain version's own
     distance from the direct sum: both are the expanded f32 form) and
     against the pairwise kernel at the JAX bar, max |dA| / (|A| + 1e-2)
     < 0.05 per component; its SASS must hold HMMA (both products on the
     tensor cores); times beside the pairwise kernel, plain and the
     bound (the largest of its FP32, rsqrt and TF32 tensor-core bounds)
 15. the merge sort (psort.sort: block-sort and merge-round kernels, no
     entry point calls it) on the PM forward-sort words (cell key, idx,
     packed fractions[, mass]) at 1M and 16M (hollow sphere, G = 128),
     the un-sort words (2 x uint32 with keys up to 2^32 - 1 at 16M; idx
     + 3 f32), the raster tile keys of the 1M @ 1280x720 frame with an
     index payload, tests/test_psort.py's distributions at 131,072, the
     ragged lengths 1,000,448 and 80,000, and uint32 keys at and above
     2^31 with key-max entries: every word equal to the plain version's
     and to a stable torch.sort's (so keys exact and (key, payload)
     multisets equal), launch counts as the lengths predict, no
     torch.sort route taken; then times of the block sort, the first and
     last merge rounds and the whole sort at 1M and 16M beside plain,
     torch.sort + index_select and the bytes bound

The line before the last is a JSON object with one entry per kernel (the
launches of pm_deposit and pm_gather are phase 12's runs (a) and (b)
together; those of pairwise_mxu, block_sort and merge_round the drives
of phases 14 and 15); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, FP32 outside the tensor cores
STEP_BYTES = 48                # 6 floats read + 6 written per particle-step
# the pairwise sum's arithmetic per pair (csrc/pairwise.cu:accumulate):
# 3 sub, r2 = 3 fma (eps^2 as the first addend), 1 rsqrt, w = 3 mul,
# 3 fma into the sum -> 18 flops (an fma is 2) in 12 FP32 instructions
PAIR_FLOPS = 18
PAIR_FP32_INSTRS = 12
# an SM issues 128 FP32 instructions a clock (the flop peak counts each fma
# as 2) and 16 MUFU rsqrt
FP32_INSTRS_PER_S = FP32_FLOPS_PER_S / 2
RSQRT_PER_S = FP32_FLOPS_PER_S / 16
N_GRAVITY = 65_536             # BASELINE.json config 3: all-pairs gravity
TF32_FLOPS_PER_S = 495e12      # H100 SXM data sheet, dense TF32 tensor cores
# the tensor-core force's work a pair (csrc/pairwise_mxu.cu): FP32 r2 = 5
# adds, the cube 2 mul, the TF32 split of w 1 sub, the stage sum 1 add
# (9 instructions), one rsqrt, and 4 mma.sync a 16 x 8 tile of pairs
# (three m16n8k8 at 2,048 flops, one m16n8k4 at 1,024): 56 flops a pair
MXU_PAIR_FP32_INSTRS = 9
MXU_PAIR_TC_FLOPS = 56


def fail(msg: str) -> None:
    raise AssertionError(msg)


def check_close(name, got, want, rtol, atol) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere.
    -> max absolute error."""
    import torch

    err = (got - want).abs()
    lim = atol + rtol * want.abs()
    bad = err > lim
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    if bad.any():
        i = int(bad.reshape(-1).nonzero()[0])
        fail(f"{name}: {int(bad.sum())} elements outside the bar; first at "
             f"{i}: {float(got.reshape(-1)[i])} vs "
             f"{float(want.reshape(-1)[i])} (bar there "
             f"{float(lim.reshape(-1)[i]):.4g})")
    return float(err.max())


def read_png(path):
    """uint8[H, W, C] of a PNG written by utils/png.py (filter 0 rows)."""
    import numpy as np

    data = open(path, "rb").read()
    off, idat = 8, b""
    while off < len(data):
        (length,) = struct.unpack(">I", data[off:off + 4])
        tag, body = data[off + 4:off + 8], data[off + 8:off + 8 + length]
        if tag == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        off += 12 + length
    ch = 4 if ctype == 6 else 3
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return raw.reshape(h, 1 + w * ch)[:, 1:].reshape(h, w, ch)


def median_ms(fns, *, reps: int = 7, inner: int = 10,
              lead_ms: float = 0.0) -> list:
    """Median ms per call of each fn, timed with CUDA events; the fns
    take turns within every repetition so drift hits them alike.

    ``lead_ms`` > 0 queues a GPU spin of about that long before the start
    event, so the host enqueues the ``inner`` calls while the GPU is busy
    and the events time the device work back to back, not the host's
    launch gaps (a call that reads back to the host still waits)."""
    import torch

    for fn in fns:                       # warm-up
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for k, fn in enumerate(fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if lead_ms > 0:
                torch.cuda._sleep(int(lead_ms * 2e6))  # ~2 GHz SM clock
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / inner)
    return [statistics.median(t) for t in times]


def mxu_plain_split(xi, xj, g, eps, r2_dtype, s_dtype):
    """accel f32[3, Ni] of the matrix-product form with every source
    active (as pairwise.pairwise_accel_mxu_ref computes it), but r^2 formed
    in ``r2_dtype`` and S summed in ``s_dtype``: which of the two f32
    cancellations sets the plain version's error."""
    import torch

    xr = xi.to(r2_dtype).T
    xi2e = (xr * xr).sum(1, keepdim=True) + eps * eps
    s = torch.zeros((4, xi.shape[1]), dtype=s_dtype, device=xi.device)
    ones = torch.ones((1, xj.shape[1]), dtype=s_dtype, device=xi.device)
    aug = torch.cat([xj.to(s_dtype), ones]) * g
    for j0 in range(0, xj.shape[1], 256):
        xs = xj[:, j0:j0 + 256].to(r2_dtype)
        r2 = (xr * -2.0) @ xs + xi2e + (xs * xs).sum(0)[None, :]
        inv = torch.rsqrt(r2)
        s += aug[:, j0:j0 + 256] @ (inv * inv * inv).to(s_dtype).T
    return (s[:3] - xi.to(s_dtype) * s[3:4]).float()


def cargs_of(words):
    return (words.key, words.rg, words.b, words.kept_list, words.kept_n)


def bucket_of(words, rc) -> int:
    """The bucket the renderer picks for these point words."""
    kept = int(words.kept_n.item()) * rc.CHUNK
    return next(bb for bb in rc.buckets(words.key.shape[0]) if kept <= bb)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def gpu_name_and_limit() -> str:
    return nvidia_smi("name,power.limit")


def bytes_ms(nbytes: float) -> float:
    """The least time, in ms, to move nbytes at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def flops_ms(flops: float) -> float:
    """The least time, in ms, for flops at the card's FP32 rate."""
    return flops / FP32_FLOPS_PER_S * 1e3


def sass_counts(lib_path, kernel: str) -> dict:
    """Counts of FP32 instructions (FADD, FMUL, FFMA), MUFU.RSQ and HMMA
    in one kernel's machine code (cuobjdump -sass of the built library)."""
    import re

    from particle_sim_tpu_torch.utils import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    body = next(s for s in sass.split("Function : ")[1:]
                if kernel in s.split()[0])
    return {"fp32": len(re.findall(r"\b(?:FADD|FMUL|FFMA)\b", body)),
            "rsq": len(re.findall(r"\bMUFU\.RSQ\b", body)),
            "hmma": len(re.findall(r"\bHMMA\b", body))}


def frame_pixels(key, n_tiles, width):
    """Frame pixel index (y * width + x) of 8x128-tile keys, and the live
    mask (keys below the sentinel)."""
    import torch

    live = key < n_tiles * 1024
    k = torch.where(live, key, 0).long()
    tile, local = k >> 10, k & 1023
    tiles_x = width // 128
    y = (tile // tiles_x) * 8 + (local >> 7)
    x = (tile % tiles_x) * 128 + (local & 127)
    return y * width + x, live


def cic_corners(pos, n_active, box_min, cell, grid, periodic, masses=None):
    """(flat cell index i64[8, N], weight f32[8, N]) of every particle's
    8 CIC corners as pm.cic_deposit_ref forms them (dead particles weigh
    0): the inputs of the deposit's library yardstick and of the per-cell
    contribution counts."""
    import torch

    from particle_sim_tpu_torch.ops import pm

    c = pm.cell_coords_dyn(pos, box_min, cell, grid, periodic)
    i0, f = pm.cic_weights(c)
    m = pm.live_mask(pos.shape[1], n_active, pos.device).float()
    if masses is not None:
        m = m * masses
    idx, w = [], []
    for cz, cy, cx in pm._CORNERS:
        (wx, wy, wz), (iz, iy, ix) = pm._corner(i0, f, grid, periodic,
                                               cz, cy, cx)
        idx.append((iz * grid + iy) * grid + ix)
        w.append(m * wx * wy * wz)
    return torch.stack(idx), torch.stack(w)


def momentum_and_com(start, end, vel, masses):
    """(|sum m v| / sum m|v|, shift of the centre of mass) in float64."""
    import numpy as np

    mom = np.abs((masses[:, None] * vel.astype(np.float64)).sum(0)).max()
    mom_rel = float(mom / (masses * np.linalg.norm(vel, axis=1)).sum())
    com0 = (masses[:, None] * start).sum(0) / masses.sum()
    com1 = (masses[:, None] * end.astype(np.float64)).sum(0) / masses.sum()
    return mom_rel, float(np.linalg.norm(com1 - com0))


# -- a minimal WebSocket client for phase 9 (every read has a timeout) ------------
class WsClient:
    def __init__(self, port: int, timeout: float = 60.0):
        import base64
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=timeout)
        key = base64.b64encode(b"chip-smoke-key!!").decode()
        self.sock.sendall((
            "GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self.sock.recv(4096)
            if not chunk:
                fail("server closed the connection during the handshake")
            resp += chunk
        head, _, self.buf = resp.partition(b"\r\n\r\n")
        if b" 101 " not in head.split(b"\r\n")[0] + b" ":
            fail(f"no WebSocket upgrade: {head[:80]!r}")

    def _exact(self, k: int) -> bytes:
        while len(self.buf) < k:
            chunk = self.sock.recv(1 << 20)
            if not chunk:
                fail("server closed the WebSocket")
            self.buf += chunk
        out, self.buf = self.buf[:k], self.buf[k:]
        return out

    def frame(self) -> tuple:
        head = self._exact(2)
        n = head[1] & 0x7F
        if n == 126:
            n = struct.unpack(">H", self._exact(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", self._exact(8))[0]
        return head[0] & 0x0F, self._exact(n)

    def send(self, obj) -> None:
        payload = json.dumps(obj).encode()
        mask = b"\x01\x02\x03\x04"
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        if len(payload) >= 126:
            fail("event too long for the short frame form")
        self.sock.sendall(bytes([0x81, 0x80 | len(payload)]) + mask + masked)

    def binary_until(self, pred, what: str, limit_s: float = 120.0) -> bytes:
        deadline = time.monotonic() + limit_s
        while time.monotonic() < deadline:
            op, payload = self.frame()
            if op == 0x2 and pred(payload):
                return payload
        fail(f"server: no frame with {what} within {limit_s} s")

    def close(self) -> None:
        self.sock.close()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "particle_sim_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (no "
              "particle_sim_tpu_torch/ beside this script)", file=sys.stderr)
        return 1

    import numpy as np

    from particle_sim_tpu_torch.app import cli, server
    from particle_sim_tpu_torch.core import generate as gen
    from particle_sim_tpu_torch.core.params import (
        Method, PairwiseParams, PMConfig, SimParams,
    )
    from particle_sim_tpu_torch.core.state import ParticleState
    from particle_sim_tpu_torch.engine import Engine
    from particle_sim_tpu_torch.ops import (
        pairwise, pairwise_cuda, pm, pm_cuda, psort, step_cuda,
    )
    from particle_sim_tpu_torch.render import raster, raster_compact as rc
    from particle_sim_tpu_torch.render import raster_sorted as rs
    from particle_sim_tpu_torch.render.camera import Camera
    from particle_sim_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_name_and_limit()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | python "
          f"{sys.version.split()[0]}")

    # -- phase 1: build ---------------------------------------------------------
    path, secs = cuda_build.build()
    cuda_build.library()
    log = path.with_suffix(".log")
    regs = [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or ln.startswith("==")] if log.exists() else []
    print(f"phase 1 build: {os.path.relpath(path, ROOT)} in {secs:.2f} s "
          f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for ln in regs:
        print(f"  ptxas: {ln}")

    err = {"step": 0.0, "compact": 0.0, "deposit": 0.0, "pairwise": 0.0,
           "sorted_deposit": 0.0, "pm_deposit": 0.0, "pm_gather": 0.0,
           "pairwise_mxu": 0.0, "sort": 0.0}
    params = [SimParams(),
              SimParams(gravity=2.0),
              SimParams(is_mouse_dragging=True,
                        mouse_position=(3.0, -7.0, 20.0), mouse_force=80.0,
                        mouse_radius=30.0, gravity=0.7)]

    def make_state(n, seed):
        pos, _, col = gen.generate(n)
        vel = np.random.default_rng(seed).normal(size=pos.shape)
        return ParticleState.from_arrays(pos, (vel * 3.0).astype(np.float32),
                                         col, device=dev)

    def frame_args(st, params_, camera):
        return (st.pos, st.vel, st.init_color,
                torch.from_numpy(params_.pack()).to(dev),
                torch.from_numpy(camera.view_proj()).to(dev), st.n_active)

    def check_frame_u8(label, fk, fp, min_lit) -> int:
        """Raise unless the kernel's frame is within one u8 level of the
        plain one and lights at least min_lit pixels. -> lit pixels."""
        u8 = (raster.to_rgba8(fk).int() - raster.to_rgba8(fp).int()).abs()
        if int(u8.max()) > 1:
            fail(f"{label}: u8 frames differ by {int(u8.max())}")
        lit = int((fk.sum(-1) > 0).sum())
        if lit < min_lit:
            fail(f"{label}: only {lit} lit pixels")
        return lit

    def check_compact(label, args, w, h, min_lit=1000):
        """Compaction kernel (bit-exact) and deposit kernel (|k - p| <=
        1e-5 + 1e-4 |p|) vs their plain versions on one frame's inputs,
        and the frame through the kernels within one u8 level."""
        words = rc.point_words(*args, width=w, height=h)
        bucket, cargs = bucket_of(words, rc), cargs_of(words)
        ck = rc.compact(*cargs, bucket=bucket, sentinel=words.sentinel)
        cp = rc.compact_plain(*cargs, bucket=bucket, sentinel=words.sentinel)
        for a, b in zip(ck, cp):
            if not torch.equal(a, b):
                fail(f"compact {label}: kernel differs from plain")
        pt = rc.pair_table(*ck, n_tiles=words.n_tiles,
                           sentinel=words.sentinel)
        dargs = (pt.table, pt.offsets, pt.key, pt.rg, pt.b)
        dk = rc.deposit(*dargs, n_tiles=words.n_tiles)
        dp = rc.deposit_plain(*dargs, n_tiles=words.n_tiles)
        err["deposit"] = max(err["deposit"], check_close(
            f"deposit {label}", dk, dp, 1e-4, 1e-5))
        fk = rc.render(*args, width=w, height=h)
        fp = rc.render(*args, width=w, height=h, plain=True)
        check_close(f"compact frame {label}", fk, fp, 1e-4, 1e-5)
        lit = check_frame_u8(f"compact frame {label}", fk, fp, min_lit)
        print(f"  compact {label}: kept {int(words.kept_n.item()) * rc.CHUNK}"
              f" of {words.key.shape[0]} points (bucket {bucket}), table "
              f"{pt.table.shape[0]} entries, {lit} lit pixels")
        return cargs, bucket, words, dargs

    def check_sorted(label, args, w, h, min_lit=1000):
        """Sorted-deposit kernel vs plain (|k - p| <= 1e-5 + 1e-4 |p| on
        raw tile sums) on one frame's inputs, and the frame through the
        kernel within one u8 level."""
        sp = rs.sort_points(raster.tile_keys(*args, width=w, height=h))
        dk = rs.deposit(sp.key, sp.rgb, sp.offsets, n_tiles=sp.n_tiles)
        dp = rs.deposit_plain(sp.key, sp.rgb, sp.offsets, n_tiles=sp.n_tiles)
        err["sorted_deposit"] = max(err["sorted_deposit"], check_close(
            f"sorted deposit {label}", dk, dp, 1e-4, 1e-5))
        fk = rs.render(*args, width=w, height=h)
        fp = rs.render(*args, width=w, height=h, plain=True)
        lit = check_frame_u8(f"sorted frame {label}", fk, fp, min_lit)
        print(f"  sorted {label}: {int(sp.offsets[-1])} drawn points, "
              f"{sp.n_tiles} tiles, largest tile slice "
              f"{int((sp.offsets[1:] - sp.offsets[:-1]).max())}, {lit} lit "
              f"pixels")
        return sp

    # -- phase 2: step kernel vs plain --------------------------------------------
    t0 = time.perf_counter()
    states = {}
    for n in (1_000_000, 16_777_216):
        st = states[n] = make_state(n, seed=0)
        for k, p in enumerate(params):
            pv = torch.from_numpy(p.pack()).to(dev)
            for sub, tol in ((1, 1e-6), (5, 1e-5)):
                pk, vk = st.pos.clone(), st.vel.clone()
                step_cuda.step(pk, vk, pv, substeps=sub)
                pp, vp_ = st.pos.clone(), st.vel.clone()
                step_cuda.step_plain(pp, vp_, pv, substeps=sub)
                torch.cuda.synchronize()
                for name, a, b in (("pos", pk, pp), ("vel", vk, vp_)):
                    e = check_close(f"step n={n} params={k} substeps={sub} "
                                    f"{name}", a, b, tol, tol)
                    err["step"] = max(err["step"], e)
    print(f"phase 2 step kernel == plain: n in (1M, 16M) x 3 params x "
          f"substeps (1, 5), max |err| {err['step']:.3g} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- phase 3: compaction + deposit kernels vs plain -----------------------------
    t0 = time.perf_counter()
    main_inputs = None
    for n, w, h in ((1_000_000, 1280, 720), (16_777_216, 1920, 1080)):
        inputs = check_compact(
            f"n={n} {w}x{h}",
            frame_args(states[n], SimParams(color_mode=1),
                       Camera(aspect=w / h)), w, h)
        if n == 1_000_000:
            main_inputs = inputs
    # the golden frame, through the kernels
    pos, vel, col = gen.generate(3000)
    vel = (pos * 0.02).astype(np.float32)
    gst_golden = ParticleState.from_arrays(pos, vel, col, device=dev)
    gfb = rc.render(gst_golden.pos, gst_golden.vel, gst_golden.init_color,
                    torch.from_numpy(SimParams().pack()).to(dev),
                    torch.from_numpy(Camera(aspect=2.0).view_proj()).to(dev),
                    gst_golden.n_active, width=256, height=128)
    golden = np.load(os.path.join(ROOT, "tests", "data",
                                  "golden_raster_256x128.npz"))["rgba"]
    gdiff = np.abs(raster.to_rgba8(gfb).cpu().numpy().astype(np.int16)
                   - golden.astype(np.int16))
    if gdiff.max() > 3:
        fail(f"golden frame through the kernels: max diff {gdiff.max()}")
    print(f"phase 3 compact == plain (bit-exact), deposit max |err| "
          f"{err['deposit']:.3g}, golden frame max diff {gdiff.max()} u8 "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- phase 4: the main path through the CLI --------------------------------------
    n_main, steps = 1_000_000, 600
    with tempfile.TemporaryDirectory() as tmp:
        frames = os.path.join(tmp, "frames")
        final = os.path.join(tmp, "final.npz")
        argv = ["--count", str(n_main), "--steps", str(steps), "--drag",
                "--orbit-mouse", "--color-mode", "1", "--render-every", "100",
                "--width", "1280", "--height", "720", "--render-dir", frames,
                "--checkpoint-every", str(steps), "--checkpoint", final]
        step_cuda.LAUNCHES = 0
        rc.COMPACT_LAUNCHES = 0
        rc.DEPOSIT_LAUNCHES = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc_code = cli.main(argv)
        wall = time.perf_counter() - t0
        launches = {"step": step_cuda.LAUNCHES,
                    "compact": rc.COMPACT_LAUNCHES,
                    "deposit": rc.DEPOSIT_LAUNCHES}
        text = out.getvalue()
        for ln in text.splitlines():
            print(f"  cli: {ln}")
        if rc_code != 0:
            fail(f"cli.main returned {rc_code}")
        done = json.loads(text.strip().splitlines()[-1])
        if done.get("done") is not True or done.get("steps") != steps:
            fail(f"no final done line: {done}")
        pngs = sorted(os.listdir(frames))
        if len(pngs) != 6:
            fail(f"expected 6 frames, got {pngs}")
        for name in pngs:
            img = read_png(os.path.join(frames, name))
            if img.shape != (720, 1280, 4) or int(img[..., :3].max()) == 0:
                fail(f"{name}: shape {img.shape}, black={img[..., :3].max() == 0}")
        with np.load(final) as z:
            p_end, v_end = z["positions"], z["velocities"]
            cli_state = ParticleState.from_arrays(
                p_end, v_end, z["init_colors"], device=dev)
    if p_end.shape != (n_main, 3) or not (np.isfinite(p_end).all()
                                          and np.isfinite(v_end).all()):
        fail("final state is not finite or has the wrong shape")
    ang = (steps - 1) * 0.02
    mouse = np.array([40.0 * np.cos(ang), 10.0 * np.sin(ang * 2.3),
                      40.0 * np.sin(ang)])
    p_start, _, _ = gen.generate(n_main)
    d0 = np.linalg.norm(p_start - mouse, axis=1)
    d1 = np.linalg.norm(p_end - mouse, axis=1)
    near = d0 < 20.0     # within the attractor's reach (2 x radius 10)
    if not (d1.mean() < d0.mean() and d1[near].mean() < d0[near].mean()):
        fail(f"mean distance to the mouse did not fall: all {d0.mean()} -> "
             f"{d1.mean()}, within reach {d0[near].mean()} -> "
             f"{d1[near].mean()}")
    if launches["step"] != steps or launches["compact"] < 6 \
            or launches["deposit"] < 6:
        fail(f"the main path missed a kernel: launches {launches}")
    print(f"phase 4 main path: cli 1M x {steps} steps in {wall:.2f} s, "
          f"6 frames, mean distance to the mouse {d0.mean():.4f} -> "
          f"{d1.mean():.4f} (within reach {d0[near].mean():.4f} -> "
          f"{d1[near].mean():.4f}), launches {launches}")

    # -- phase 5: times of the attractor path's kernels ----------------------------
    timing = {}
    pv = torch.from_numpy(params[2].pack()).to(dev)
    for n in (1_000_000, 16_777_216):
        st = states[n]
        pk, vk = st.pos.clone(), st.vel.clone()
        pp, vp_ = st.pos.clone(), st.vel.clone()
        inner = 50 if n == 1_000_000 else 10
        k_ms, p_ms = median_ms(
            [lambda: step_cuda.step(pk, vk, pv),
             lambda: step_cuda.step_plain(pp, vp_, pv)], inner=inner,
            lead_ms=inner * 0.5)
        timing[n] = (k_ms, p_ms)
        roof = bytes_ms(STEP_BYTES * n)
        print(f"phase 5 step n={n}: kernel {k_ms:.5f} ms "
              f"({n / k_ms * 1e3:.4g} particle-steps/s, "
              f"{roof / k_ms:.1%} of the 3.35 TB/s HBM roofline) | plain "
              f"{p_ms:.5f} ms ({n / p_ms * 1e3:.4g} particle-steps/s, "
              f"{roof / p_ms:.1%}) | bound {roof:.5f} ms | library: none")
    cargs, bucket, words, dargs = main_inputs
    # the one PyTorch call for the compaction: index_select of the kept
    # chunks of the three word planes, stacked
    stacked = torch.stack(cargs[:3]).view(3, -1, rc.CHUNK)
    kept_idx = words.kept_list[: bucket // rc.CHUNK].long()
    ck_ms, cp_ms, cl_ms = median_ms(
        [lambda: rc.compact(*cargs, bucket=bucket, sentinel=words.sentinel),
         lambda: rc.compact_plain(*cargs, bucket=bucket,
                                  sentinel=words.sentinel),
         lambda: torch.index_select(stacked, 1, kept_idx)], inner=20,
        lead_ms=20 * 0.3)
    # compaction bound: the kept words read, the bucket written
    c_bound = bytes_ms(12 * int(words.kept_n.item()) * rc.CHUNK
                       + 12 * bucket)
    # the one PyTorch call for the deposit: index_put_ with accumulation of
    # the points that each table entry's chunk adds to the entry's tile,
    # into the frame (the same sum before the clamp)
    table, offsets, key_p, rg_p, b_p = dargs
    keep = (table & rc._F_BIT) == 0
    s_idx = torch.clamp(table & rc._S_MASK,
                        max=key_p.shape[0] // rc.CHUNK - 1).long()[keep]
    ent_t = ((table >> rc._T_SHIFT) & rc._MAX_TILES)[keep]
    ekey = key_p.view(-1, rc.CHUNK)[s_idx]
    inside = (ekey >> 10) == ent_t[:, None]
    pix, live = frame_pixels(torch.where(inside, ekey, words.sentinel),
                             words.n_tiles, 1280)
    r_, g_, b_ = rc.unpack_rgb_bf16(rg_p.view(-1, rc.CHUNK)[s_idx],
                                    b_p.view(-1, rc.CHUNK)[s_idx])
    lib_pix = pix[live]
    lib_rgb = torch.stack([r_, g_, b_], -1)[live]
    fb_lib = torch.zeros((720 * 1280, 3), dtype=torch.float32, device=dev)
    dk_ms, dp_ms, dl_ms = median_ms(
        [lambda: rc.deposit(*dargs, n_tiles=words.n_tiles),
         lambda: rc.deposit_plain(*dargs, n_tiles=words.n_tiles),
         lambda: fb_lib.index_put_((lib_pix,), lib_rgb, accumulate=True)],
        inner=5, lead_ms=5 * 0.5)
    # deposit bound: the point words read, the framebuffer written
    d_bound = bytes_ms(key_p.numel() * 12 + words.n_tiles * 3 * 1024 * 4)
    print(f"phase 5 compact 1M@1280x720: kernel {ck_ms:.5f} ms | plain "
          f"{cp_ms:.5f} ms | index_select {cl_ms:.5f} ms | bound "
          f"{c_bound:.5f} ms")
    print(f"phase 5 deposit 1M@1280x720: kernel {dk_ms:.5f} ms | plain "
          f"{dp_ms:.5f} ms | index_put_ {dl_ms:.5f} ms | bound "
          f"{d_bound:.5f} ms")

    # -- phase 6: pairwise kernel vs plain ---------------------------------------------
    t0 = time.perf_counter()
    gpos, _, gcol = gen.generate(N_GRAVITY, gen.SphereGeneration.FILLED)
    x = torch.from_numpy(np.ascontiguousarray(gpos.T)).to(dev)  # f32[3, N]
    poisoned = x.clone()
    poisoned[:, 60_000:] = 1e3
    masses = torch.ones(N_GRAVITY, dtype=torch.float32, device=dev)
    masses[0] = 1000.0
    half = N_GRAVITY // 2
    cases = [("square", x, N_GRAVITY, {}),
             ("60000 active, poisoned padding", poisoned, 60_000, {}),
             ("central mass 1000", x, N_GRAVITY, {"masses": masses}),
             ("65536 x 32768, j_base 32768", x, N_GRAVITY,
              {"j_base": half, "src": x[:, half:].contiguous()})]
    for label, xs, n_act, kw in cases:
        kw = dict(kw)
        src = kw.pop("src", xs)
        got = pairwise_cuda.pairwise_accel(xs.T, src, n_act, 1.0, 0.5, **kw)
        want = pairwise.pairwise_accel(xs.T, src, n_act, 1.0, 0.5, **kw)
        torch.cuda.synchronize()
        scale = want.abs().amax(0)
        e = check_close(f"pairwise {label}", got, want, 0.0,
                        1e-4 * scale[None, :])
        err["pairwise"] = max(err["pairwise"], e)
        rel = float(((got - want).abs().amax(0) / scale).max())
        print(f"  pairwise {label}: max |k - p| {e:.3g} "
              f"({rel:.3g} of max|p| {float(scale.max()):.4g})")
    # one direct-sum step: kernel + plain kick + step kernel vs plain step
    gst = ParticleState.from_arrays(
        gpos, np.random.default_rng(1).normal(size=gpos.shape).astype(
            np.float32), gcol, device=dev)
    spv = torch.from_numpy(SimParams(
        gravity=0.3, is_mouse_dragging=True, mouse_position=(0.0, 0.0, 10.0),
        mouse_force=20.0).pack()).to(dev)
    spp = torch.from_numpy(PairwiseParams(1.0, 0.5).pack()).to(dev)
    pk, vk = gst.pos.clone(), gst.vel.clone()
    pairwise_cuda.step_pairwise(pk, vk, spv, spp, gst.n_active)
    pp_, vp_ = pairwise.step_pairwise(gst.pos, gst.vel, spv, spp,
                                      gst.n_active)
    torch.cuda.synchronize()
    acc_scale = float(pairwise.pairwise_accel(
        x.T, x, N_GRAVITY, 1.0, 0.5).abs().max())
    dv = 1e-4 * acc_scale * 0.016          # the accel bar times dt
    ev = check_close("step_pairwise vel", vk, vp_, 1e-5, dv)
    ep = check_close("step_pairwise pos", pk, pp_, 1e-5, dv * 0.016 + 1e-5)
    print(f"phase 6 pairwise kernel == plain at {N_GRAVITY}: 4 cases, max "
          f"|err| {err['pairwise']:.3g} (bar 1e-4 max|p| per component); "
          f"step_pairwise max |err| vel {ev:.3g} pos {ep:.3g} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- phase 7: sorted-deposit kernel vs plain --------------------------------------
    t0 = time.perf_counter()
    sorted_inputs = {}
    for n, w, h in ((1_000_000, 1280, 720), (16_777_216, 1920, 1080)):
        args = frame_args(states[n], SimParams(color_mode=1),
                          Camera(aspect=w / h))
        sorted_inputs[n] = (check_sorted(f"n={n} {w}x{h}", args, w, h), w, h)
    gfb = rs.render(gst_golden.pos, gst_golden.vel, gst_golden.init_color,
                    torch.from_numpy(SimParams().pack()).to(dev),
                    torch.from_numpy(Camera(aspect=2.0).view_proj()).to(dev),
                    gst_golden.n_active, width=256, height=128)
    sdiff = np.abs(raster.to_rgba8(gfb).cpu().numpy().astype(np.int16)
                   - golden.astype(np.int16))
    if sdiff.max() > 3:
        fail(f"golden frame through the sorted kernel: max diff "
             f"{sdiff.max()}")
    print(f"phase 7 sorted deposit == plain, max |err| "
          f"{err['sorted_deposit']:.3g} (bar 1e-5 + 1e-4|p|), frames within "
          f"1 u8, golden frame max diff {sdiff.max()} u8 "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- phase 8: the gravity main path through the CLI ----------------------------------
    g_steps = 200
    with tempfile.TemporaryDirectory() as tmp:
        frames = os.path.join(tmp, "frames")
        final = os.path.join(tmp, "final.npz")
        argv = ["--device", "cuda", "--pairwise", "--count", str(N_GRAVITY),
                "--central-mass", "1000", "--steps", str(g_steps),
                "--render-every", "100", "--renderer", "sorted",
                "--color-mode", "1", "--width", "1280", "--height", "720",
                "--render-dir", frames, "--checkpoint-every", str(g_steps),
                "--checkpoint", final, "--stats-every", "100"]
        step_cuda.LAUNCHES = 0
        pairwise_cuda.LAUNCHES = 0
        rs.LAUNCHES = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc_code = cli.main(argv)
        g_wall = time.perf_counter() - t0
        g_launches = {"pairwise": pairwise_cuda.LAUNCHES,
                      "sorted_deposit": rs.LAUNCHES,
                      "step": step_cuda.LAUNCHES}
        text = out.getvalue()
        for ln in text.splitlines():
            print(f"  cli: {ln}")
        if rc_code != 0:
            fail(f"gravity cli.main returned {rc_code}")
        done = json.loads(text.strip().splitlines()[-1])
        if done.get("done") is not True or done.get("steps") != g_steps:
            fail(f"gravity path: no final done line: {done}")
        pngs = sorted(os.listdir(frames))
        if len(pngs) != 2:
            fail(f"gravity path: expected 2 frames, got {pngs}")
        for name in pngs:
            img = read_png(os.path.join(frames, name))
            if img.shape != (720, 1280, 4) or int(img[..., :3].max()) == 0:
                fail(f"gravity path {name}: shape {img.shape}, black="
                     f"{img[..., :3].max() == 0}")
        with np.load(final) as z:
            g_end, gv_end = z["positions"], z["velocities"]
            g_m = z["masses"].astype(np.float64)
            g_col = z["init_colors"]
    if g_end.shape != (N_GRAVITY, 3) or not (np.isfinite(g_end).all()
                                             and np.isfinite(gv_end).all()):
        fail("gravity path: final state is not finite or has the wrong shape")
    if g_m[0] != 1000.0 or g_m[1:].max() != 1.0:
        fail(f"gravity path: masses not kept ({g_m[:3]})")
    # the CLI starts from the hollow sphere (radius 50) at rest: internal
    # forces cancel pairwise (with any masses) and damping scales every
    # velocity alike, so the total momentum stays 0 and the centre of mass
    # stays where it was
    g_start = gen.generate(N_GRAVITY)[0]
    r0 = float(np.linalg.norm(g_start, axis=1).mean())
    r1 = float(np.linalg.norm(g_end, axis=1).mean())
    mom = np.abs((g_m[:, None] * gv_end.astype(np.float64)).sum(0)).max()
    mom_rel = float(mom / (g_m * np.linalg.norm(gv_end, axis=1)).sum())
    com0 = (g_m[:, None] * g_start).sum(0) / g_m.sum()
    com1 = (g_m[:, None] * g_end.astype(np.float64)).sum(0) / g_m.sum()
    com_shift = float(np.linalg.norm(com1 - com0))
    if not (mom_rel < 1e-3 and com_shift < 0.5):
        fail(f"gravity path: momentum |P| / sum m|v| = {mom_rel:.3g} (bar "
             f"1e-3), centre of mass moved {com_shift:.3g} (bar 0.5)")
    if g_launches != {"pairwise": g_steps, "sorted_deposit": 2,
                      "step": g_steps}:
        fail(f"the gravity path missed a kernel: launches {g_launches}")
    # the sorted-deposit kernel at this path's own shape and data: the
    # CLI's final state (the collapsed cloud), 65,536 points @ 1280x720
    check_sorted(f"gravity cli final state n={N_GRAVITY} 1280x720",
                 frame_args(ParticleState.from_arrays(g_end, gv_end, g_col,
                                                      device=dev),
                            SimParams(color_mode=1), Camera(aspect=1280 / 720)),
                 1280, 720, min_lit=1)
    print(f"phase 8 gravity main path: cli {N_GRAVITY} x {g_steps} steps "
          f"--pairwise --central-mass 1000 --renderer sorted in "
          f"{g_wall:.2f} s, 2 frames, mean radius {r0:.4f} -> {r1:.4f}, "
          f"|P| / sum m|v| {mom_rel:.3g}, centre of mass moved "
          f"{com_shift:.3g}, "
          f"launches {g_launches}; sorted deposit == plain on its final "
          f"state, max |err| so far {err['sorted_deposit']:.3g}")

    # -- phase 9: the WebSocket server on the card -------------------------------------
    hdr = server.HEADER_BYTES
    eng = Engine(particle_count=N_GRAVITY, device="cuda", method=Method.CUDA)
    srv = server.StreamServer(eng, host="127.0.0.1", port=0, target_fps=60)
    pairwise_cuda.LAUNCHES = 0
    rc.COMPACT_LAUNCHES = 0
    rc.DEPOSIT_LAUNCHES = 0
    step_cuda.LAUNCHES = 0
    pm_cuda.DEPOSIT_LAUNCHES = 0
    pm_cuda.GATHER_LAUNCHES = 0
    t0 = time.perf_counter()
    srv.start()
    try:
        ws = WsClient(srv.port)
        op, hello = ws.frame()
        hello = json.loads(hello.decode()) if op == 0x1 else {}
        if hello.get("type") != "hello" or hello.get("count") != N_GRAVITY \
                or "pallas" not in hello.get("methods", []):
            fail(f"server hello: {hello}")
        ws.send({"type": "solver", "name": "direct", "g": 1.0,
                 "softening": 0.5, "seq": 5})
        modes = {}
        f0 = ws.binary_until(lambda f: struct.unpack(
            server.HEADER_FMT, f[:hdr])[7] >= 5, "reflected_seq >= 5")
        modes[0] = f0
        ws.send({"type": "view", "mode": "compact"})
        modes[1] = ws.binary_until(lambda f: struct.unpack(
            "<I", f[4:8])[0] == 1, "mode 1")
        ws.send({"type": "params", "gravity": 2.0, "seq": 6})
        ws.send({"type": "view", "mode": "raster", "width": 1280,
                 "height": 720})
        modes[2] = ws.binary_until(lambda f: struct.unpack(
            "<I", f[4:8])[0] == 2 and struct.unpack(
            server.HEADER_FMT, f[:hdr])[7] >= 6, "mode 2, reflected_seq 6")
        # the particle-mesh solver, as the viewer's solver menu sends it
        ws.send({"type": "solver", "name": "pm", "g": 1.0, "softening": 2.0,
                 "auto_box": False, "pm2_sizes": [], "pmx_size": 0,
                 "seq": 7})
        pm_frame = ws.binary_until(lambda f: struct.unpack(
            server.HEADER_FMT, f[:hdr])[7] >= 7, "reflected_seq 7 (pm)")
        ws.close()
        ws2 = WsClient(srv.port)
        op, hello2 = ws2.frame()
        hello2 = json.loads(hello2.decode()) if op == 0x1 else {}
        ws2.close()
    finally:
        srv.stop()
    s_wall = time.perf_counter() - t0
    srv_state, srv_pm = eng.state, eng.pm     # held against plain in phase 11
    s_launches = {"pairwise": pairwise_cuda.LAUNCHES,
                  "compact": rc.COMPACT_LAUNCHES,
                  "deposit": rc.DEPOSIT_LAUNCHES,
                  "step": step_cuda.LAUNCHES,
                  "pm_deposit": pm_cuda.DEPOSIT_LAUNCHES,
                  "pm_gather": pm_cuda.GATHER_LAUNCHES}
    summary = []
    for mode, frame in modes.items():
        (magic, fmode, count, fid, total, fps, upd, rseq, lat,
         flags) = struct.unpack(server.HEADER_FMT, frame[:hdr])
        if magic != server.MAGIC or fmode != mode or total != N_GRAVITY:
            fail(f"server mode {mode}: header {magic:#x} {fmode} {total}")
        want = {0: hdr + 16 * count, 1: hdr + 10 * count,
                2: hdr + 8 + 4 * count}[mode]
        if len(frame) != want:
            fail(f"server mode {mode}: {len(frame)} bytes, expected {want}")
        summary.append(f"mode {mode}: count {count} frame {fid} "
                       f"reflected_seq {rseq} latency {lat:.3f} ms")
    pos0 = np.frombuffer(modes[0], np.float32, 3 * N_GRAVITY, hdr)
    if not np.isfinite(pos0).all():
        fail("server mode 0: non-finite positions")
    w2, h2 = struct.unpack("<II", modes[2][hdr:hdr + 8])
    img2 = np.frombuffer(modes[2], np.uint8, offset=hdr + 8).reshape(
        h2, w2, 4)
    if (w2, h2) != (1280, 720) or int(img2[..., :3].max()) == 0:
        fail(f"server mode 2: {w2}x{h2}, black={img2[..., :3].max() == 0}")
    if eng.pm != PMConfig(softening=2.0) \
            or eng.pairwise != PairwiseParams(1.0, 2.0):
        fail(f"server: the pm solver event did not switch the engine "
             f"({eng.pm}, {eng.pairwise})")
    if hello2.get("solver") != "pm":
        fail(f"server: the status after the pm event says {hello2}")
    if struct.unpack(server.HEADER_FMT, pm_frame[:hdr])[4] != N_GRAVITY:
        fail("server: the frame after the pm event has the wrong count")
    if min(s_launches.values()) < 1:
        fail(f"the server path missed a kernel: launches {s_launches}")
    # the compaction and deposit kernels at the server's own shapes: its
    # engine's state, parameters and camera, 65,536 points @ 1280x720
    check_compact(f"server state n={N_GRAVITY} 1280x720",
                  frame_args(eng.state, srv.params, srv.camera), 1280, 720,
                  min_lit=1)
    print(f"phase 9 server at {N_GRAVITY}: {' | '.join(summary)}; then a "
          f"\"pm\" solver event, reflected (seq 7), status solver "
          f"{hello2.get('solver')!r}; "
          f"launches {s_launches} ({s_wall:.2f} s); compact (bit-exact) and "
          f"deposit == plain on its state, deposit max |err| so far "
          f"{err['deposit']:.3g}")

    # -- phase 10: times of the gravity and sorted-frame kernels --------------------------
    clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    pairs = float(N_GRAVITY) * N_GRAVITY
    # three operation bounds at the data sheet's FP32 peak; the bound is
    # the largest (the FP32 issue: only half the instructions are fmas)
    pw_flops = flops_ms(PAIR_FLOPS * pairs)
    pw_issue = PAIR_FP32_INSTRS * pairs / FP32_INSTRS_PER_S * 1e3
    pw_rsqrt = pairs / RSQRT_PER_S * 1e3
    pw_bound = max(pw_flops, pw_issue, pw_rsqrt)
    pw_clock = PAIR_FP32_INSTRS * pairs / (132 * 128 * clk_mhz * 1e6) * 1e3
    pw_sass = sass_counts(path, "pairwise_kernel")
    sass_fp32, sass_rsq = pw_sass["fp32"], pw_sass["rsq"]
    (pw_ms,) = median_ms(
        [lambda: pairwise_cuda.pairwise_accel(x.T, x, N_GRAVITY, 1.0, 0.5)],
        reps=7, inner=5, lead_ms=5 * 4.0)
    (pwp_ms,) = median_ms(
        [lambda: pairwise.pairwise_accel(x.T, x, N_GRAVITY, 1.0, 0.5)],
        reps=3, inner=1)
    print(f"phase 10 pairwise {N_GRAVITY}^2: kernel {pw_ms:.4f} ms "
          f"({pairs / pw_ms * 1e3:.4g} pairs/s, {pw_bound / pw_ms:.1%} of the "
          f"bound) | plain {pwp_ms:.3f} ms | bound {pw_bound:.4f} ms "
          f"(largest of: {PAIR_FP32_INSTRS} FP32 instructions/pair at 128/SM/"
          f"clock {pw_issue:.4f} ms; {PAIR_FLOPS} flops/pair at 67 TFLOP/s "
          f"{pw_flops:.4f} ms; rsqrt at 16/SM/clock {pw_rsqrt:.4f} ms; the "
          f"FP32 issue bound at the reported max SM clock {clk_mhz:.0f} MHz "
          f"{pw_clock:.4f} ms; the kernel's SASS: {sass_fp32} FP32 "
          f"instructions over {sass_rsq} MUFU.RSQ = "
          f"{sass_fp32 / max(sass_rsq, 1):.2f} a pair) | library: none | grid "
          f"{-(-N_GRAVITY // 256)} blocks x 8 warps = "
          f"{-(-N_GRAVITY // 256) * 8 / 132:.1f} warps per SM of 64")
    sd_timing = {}
    for n, (sp, w, h) in sorted_inputs.items():
        pix, live = frame_pixels(sp.key, sp.n_tiles, w)
        lib_pix = pix[live]
        lib_rgb = sp.rgb.T[live].contiguous()
        fb_lib = torch.zeros((h * w, 3), dtype=torch.float32, device=dev)
        inner = 10 if n == 1_000_000 else 3
        k_ms, p_ms, l_ms = median_ms(
            [lambda: rs.deposit(sp.key, sp.rgb, sp.offsets,
                                n_tiles=sp.n_tiles),
             lambda: rs.deposit_plain(sp.key, sp.rgb, sp.offsets,
                                      n_tiles=sp.n_tiles),
             lambda: fb_lib.index_put_((lib_pix,), lib_rgb,
                                       accumulate=True)],
            inner=inner, lead_ms=inner * (0.5 if n == 1_000_000 else 8.0))
        bound = bytes_ms(16 * n + 12 * w * h)
        sd_timing[n] = (k_ms, p_ms, l_ms, bound)
        print(f"phase 10 sorted deposit n={n} {w}x{h}: kernel {k_ms:.5f} ms "
              f"| plain {p_ms:.5f} ms | index_put_ {l_ms:.5f} ms | bound "
              f"{bound:.5f} ms ({bound / k_ms:.1%})")
    # frames: the random-velocity states of phases 2-3 (every point lit),
    # and the attractor path's own final state (lit only where the mouse
    # pulled)
    for label, st, w, h in (("n=1000000", states[1_000_000], 1280, 720),
                            ("n=16777216", states[16_777_216], 1920, 1080),
                            ("cli final state n=1000000", cli_state, 1280,
                             720)):
        args = (st.pos, st.vel, st.init_color,
                torch.from_numpy(SimParams(color_mode=1).pack()).to(dev),
                torch.from_numpy(Camera(aspect=w / h).view_proj()).to(dev),
                st.n_active)
        fs_ms, fk_ms, fp_ms, fsc_ms = median_ms(
            [lambda: rs.render(*args, width=w, height=h),
             lambda: rc.render(*args, width=w, height=h),
             lambda: rc.render(*args, width=w, height=h, plain=True),
             lambda: raster.render(*args, width=w, height=h)], inner=3)
        print(f"phase 10 frame {label} {w}x{h}: sorted (kernel) "
              f"{fs_ms:.4f} ms | compact (kernels) {fk_ms:.4f} ms"
              f" | compact (plain) {fp_ms:.4f} ms | scatter (plain) "
              f"{fsc_ms:.4f} ms")
        # each frame's layers, one at a time (device times)
        keys = raster.tile_keys(*args, width=w, height=h)
        sp = rs.sort_points(keys)
        words = rc.point_words(*args, width=w, height=h)
        bucket = bucket_of(words, rc)
        ck = rc.compact(*cargs_of(words), bucket=bucket,
                        sentinel=words.sentinel)
        pt = rc.pair_table(*ck, n_tiles=words.n_tiles,
                           sentinel=words.sentinel)
        layers = median_ms(
            [lambda: raster.tile_keys(*args, width=w, height=h),
             lambda: rs.sort_points(keys),
             lambda: rs.deposit(sp.key, sp.rgb, sp.offsets,
                                n_tiles=sp.n_tiles),
             lambda: rc.point_words(*args, width=w, height=h),
             lambda: words.kept_n.item(),
             lambda: rc.compact(*cargs_of(words), bucket=bucket,
                                sentinel=words.sentinel),
             lambda: rc.pair_table(*ck, n_tiles=words.n_tiles,
                                   sentinel=words.sentinel),
             lambda: rc.deposit(pt.table, pt.offsets, pt.key, pt.rg, pt.b,
                                n_tiles=words.n_tiles)],
            inner=3, lead_ms=10.0)
        print(f"  layers (compact kept "
              f"{int(words.kept_n.item()) * rc.CHUNK} points): " + " | ".join(
                  f"{name} {ms:.4f} ms" for name, ms in zip(
                      ("sorted: tile_keys", "sort_points", "deposit",
                       "compact: point_words", "kept_n host read", "compact",
                       "pair_table", "deposit"), layers)))

    # -- phase 11: the PM kernels vs plain ----------------------------------------------
    t0 = time.perf_counter()

    def check_pm(label, pos, n_act, cfg, masses=None, exact_ref=False):
        """Deposit (unit masses, and with ``masses`` when given) and gather
        kernels vs their plain versions at cfg's grid and static box.
        Deposit bar 1e-5 max|p| (f32 sums in atomic order). With
        ``exact_ref`` the deposit is held instead against a float64 sum of
        the same f32 corner weights (pm.cic_deposit_ref's terms, which the
        kernel forms bit for bit), within K u |p| per cell, K its nonzero
        contributions: an f32 sum of K non-negative terms in any order
        lies within (K - 1) u of the exact sum (the recursive-summation
        bound). Particles clamped onto one box edge add identical weights,
        so there the rounding errors add up instead of averaging out.
        Gather bar 1e-6 max|p| (the same weights in the same corner
        order)."""
        periodic = cfg.boundary == "periodic"
        box, cell, g = cfg.box_min, cfg.cell_size, cfg.grid
        notes = []
        for m in ((None,) if masses is None else (None, masses)):
            dk = pm_cuda.deposit(pos, n_act, box, cell, g, periodic=periodic,
                                 masses=m)
            dp = pm_cuda.deposit_plain(pos, n_act, box, cell, g,
                                       periodic=periodic, masses=m)
            torch.cuda.synchronize()
            scale = float(dp.abs().max())
            bar, k_note = 1e-5 * scale, ""
            if exact_ref:
                idx, w = cic_corners(pos, n_act, box, cell, g, periodic, m)
                idx, w = idx.reshape(-1), w.reshape(-1).double()
                dp = torch.zeros(g ** 3, dtype=torch.float64,
                                 device=dev).index_add_(0, idx, w)
                dp = dp.reshape(g, g, g)
                counts = torch.bincount(idx, weights=(w != 0).double(),
                                        minlength=g ** 3).reshape(g, g, g)
                bar = counts * 2.0 ** -24 * dp
                dk = dk.double()
                worst = float(((dk - dp).abs() / bar.clamp_min(1e-300))
                              .max())
                k_note = (f" (float64 reference), hottest cell "
                          f"{int(counts.max())} contributions, worst "
                          f"|k - p| / (K u |p|) {worst:.4g}")
            e = check_close(f"pm deposit {label}", dk, dp, 0.0, bar)
            err["pm_deposit"] = max(err["pm_deposit"], e)
            notes.append(f"deposit{'' if m is None else ' (masses)'} "
                         f"{e:.3g} = {e / scale:.3g} of max|p| {scale:.6g}"
                         f"{k_note}")
        grids = pm.solve_accel(dp, cfg, cfg.softening)
        gk = pm_cuda.gather(grids, pos, n_act, box, cell, periodic=periodic)
        gp = pm_cuda.gather_plain(grids, pos, n_act, box, cell,
                                  periodic=periodic)
        torch.cuda.synchronize()
        scale = float(gp.abs().max())
        e = check_close(f"pm gather {label}", gk, gp, 0.0, 1e-6 * scale)
        err["pm_gather"] = max(err["pm_gather"], e)
        notes.append(f"gather {e:.3g} = {e / scale:.3g} of max|p| "
                     f"{scale:.6g}")
        print(f"  pm {label}: max |k - p|: " + "; ".join(notes))

    def check_pm_accel(label, pos, n_act, cfg, masses=None) -> float:
        """pm_cuda.pm_accel (kernels) vs pm.pm_accel_ref (plain): bar 1e-4
        max|a| (the deposit's summation order, through the FFTs); padding
        exactly 0. -> max error over max|a|."""
        ak = pm_cuda.pm_accel(pos, n_act, 1.0, cfg, masses=masses)
        ap = pm.pm_accel_ref(pos, n_act, 1.0, cfg.softening, cfg,
                             masses=masses)
        torch.cuda.synchronize()
        scale = float(ap.abs().max())
        e = check_close(f"pm_accel {label}", ak, ap, 0.0, 1e-4 * scale)
        if not bool((ak[:, int(n_act):] == 0).all()):
            fail(f"pm_accel {label}: padding is not 0")
        print(f"  pm_accel {label}: max |k - p| {e:.3g} = "
              f"{e / scale:.3g} of max|a| {scale:.6g}")
        return e / scale

    pm_st = states[1_000_000]
    pm_pos, pm_n = pm_st.pos.reshape(3, -1), pm_st.n_active
    cap1 = pm_pos.shape[1]
    pm_masses = torch.from_numpy((np.random.default_rng(3).random(cap1)
                                  + 0.5).astype(np.float32)).to(dev)
    strays = pm_pos.clone()
    strays[0, ::10] += 100.0          # a tenth of the particles out of the
    strays[2, 5::10] -= 90.0          # box on +x, another tenth on -z
    pm_cases = [
        ("1M hollow sphere G=128 isolated", pm_pos, PMConfig(), pm_masses),
        ("1M with strays G=128 periodic", strays,
         PMConfig(boundary="periodic"), None),
        ("1M hollow sphere G=32", pm_pos, PMConfig(grid=32, softening=8.0),
         None),
        ("1M hollow sphere G=96", pm_pos, PMConfig(grid=96), None),
        ("1M hollow sphere G=256", pm_pos, PMConfig(grid=256), None)]
    accel_rel = 0.0
    for label, pos_c, cfg_c, m_c in pm_cases:
        check_pm(label, pos_c, pm_n, cfg_c, masses=m_c)
        accel_rel = max(accel_rel, check_pm_accel(label, pos_c, pm_n, cfg_c,
                                                  masses=m_c))
    accel_rel = max(accel_rel, check_pm_accel(
        "1M hollow sphere G=128 auto_box, masses", pm_pos, pm_n,
        PMConfig(auto_box=True), masses=pm_masses))
    # the server path's own shape and data: its state after the "pm" event
    check_pm(f"server state n={N_GRAVITY}", srv_state.pos.reshape(3, -1),
             srv_state.n_active, srv_pm)
    # PM against the direct sum (the pairwise kernel): the bar of
    # tests/test_pm.py, rms relative error < 0.05
    cfg5 = PMConfig(softening=5.0)
    a_pm = pm_cuda.pm_accel(x, N_GRAVITY, 1.0, cfg5)
    a_dir = pairwise_cuda.pairwise_accel(x.T, x, N_GRAVITY, 1.0, 5.0).T
    torch.cuda.synchronize()
    pm_rms = float((a_pm - a_dir).norm(dim=0).pow(2).mean().sqrt()
                   / a_dir.norm(dim=0).mean())
    if not pm_rms < 0.05:
        fail(f"PM vs the direct sum at {N_GRAVITY}: rms relative error "
             f"{pm_rms:.4g} (bar 0.05)")
    print(f"phase 11 pm kernels == plain: deposit max |err| "
          f"{err['pm_deposit']:.3g} (bar 1e-5 max|p|), gather max |err| "
          f"{err['pm_gather']:.3g} (bar 1e-6 max|p|), pm_accel max "
          f"{accel_rel:.3g} of max|a| (bar 1e-4); PM (G=128, eps 5) vs the "
          f"pairwise kernel at {N_GRAVITY}: rms relative error {pm_rms:.4g} "
          f"(bar 0.05) ({time.perf_counter() - t0:.1f} s)")

    # -- phase 12: the PM main path through the CLI ------------------------------------
    n_pm = 1_000_000
    pm_runs = {}
    for tag, steps_, extra in (
            ("a", 600, ["--pm", "--pm-auto-box", "--pairwise-g", "0.08",
                        "--dt", "0.004", "--diagnostics"]),
            ("b", 200, ["--pm", "--central-mass", "1000", "--renderer",
                        "sorted", "--render-every", "100", "--color-mode",
                        "1"])):
        with tempfile.TemporaryDirectory() as tmp:
            frames = os.path.join(tmp, "frames")
            final = os.path.join(tmp, "final.npz")
            argv = ["--device", "cuda", "--count", str(n_pm), "--steps",
                    str(steps_), *extra, "--width", "1280", "--height", "720",
                    "--render-dir", frames, "--checkpoint-every", str(steps_),
                    "--checkpoint", final, "--stats-every", "100"]
            step_cuda.LAUNCHES = 0
            rs.LAUNCHES = 0
            pm_cuda.DEPOSIT_LAUNCHES = 0
            pm_cuda.DEPOSIT_MASS_LAUNCHES = 0
            pm_cuda.GATHER_LAUNCHES = 0
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc_code = cli.main(argv)
            wall = time.perf_counter() - t0
            got = {"pm_deposit": pm_cuda.DEPOSIT_LAUNCHES,
                   "pm_deposit_mass": pm_cuda.DEPOSIT_MASS_LAUNCHES,
                   "pm_gather": pm_cuda.GATHER_LAUNCHES,
                   "step": step_cuda.LAUNCHES,
                   "sorted_deposit": rs.LAUNCHES}
            text = out.getvalue()
            for ln in text.splitlines():
                print(f"  cli ({tag}): {ln}")
            if rc_code != 0:
                fail(f"pm cli ({tag}) returned {rc_code}")
            lines = [json.loads(ln) for ln in text.strip().splitlines()]
            if lines[-1].get("done") is not True \
                    or lines[-1].get("steps") != steps_:
                fail(f"pm cli ({tag}): no final done line: {lines[-1]}")
            pngs = (sorted(os.listdir(frames)) if os.path.isdir(frames)
                    else [])
            for name in pngs:
                img = read_png(os.path.join(frames, name))
                if img.shape != (720, 1280, 4) or int(img[..., :3].max()) == 0:
                    fail(f"pm cli ({tag}) {name}: shape {img.shape}, black="
                         f"{img[..., :3].max() == 0}")
            with np.load(final) as z:
                end = (z["positions"], z["velocities"], z["init_colors"],
                       z["masses"] if "masses" in z.files else None)
        pm_runs[tag] = (got, wall, lines, pngs, end)
    start = gen.generate(n_pm)[0].astype(np.float64)
    for tag, (got, wall, lines, pngs, (p_end, v_end, _, m_end)) \
            in pm_runs.items():
        steps_ = lines[-1]["steps"]
        # each diagnostics line of (a) deposits and gathers once more
        n_diag = sum("potential" in ln for ln in lines)
        want = {"pm_deposit": steps_ + n_diag if tag == "a" else 0,
                "pm_deposit_mass": 0 if tag == "a" else steps_,
                "pm_gather": steps_ + n_diag, "step": steps_,
                "sorted_deposit": 0 if tag == "a" else 2}
        if got != want:
            fail(f"the pm path ({tag}) missed a kernel: launches {got}, "
                 f"expected {want}")
        if p_end.shape != (n_pm, 3) or not (np.isfinite(p_end).all()
                                            and np.isfinite(v_end).all()):
            fail(f"pm path ({tag}): final state not finite or misshapen")
        masses_np = (np.ones(n_pm) if m_end is None
                     else m_end.astype(np.float64))
        if tag == "b" and (masses_np[0] != 1000.0
                           or masses_np[1:].max() != 1.0):
            fail(f"pm path (b): masses not kept ({masses_np[:3]})")
        if tag == "b" and len(pngs) != 2:
            fail(f"pm path (b): expected 2 frames, got {pngs}")
        mom_rel, com_shift = momentum_and_com(start, p_end, v_end, masses_np)
        if not (mom_rel < 1e-3 and com_shift < 0.5):
            fail(f"pm path ({tag}): |P| / sum m|v| = {mom_rel:.3g} (bar "
                 f"1e-3), centre of mass moved {com_shift:.3g} (bar 0.5)")
        stats = [ln for ln in lines if "step" in ln]
        if tag == "a":
            if [ln["step"] for ln in stats] != list(range(100, 601, 100)):
                fail(f"pm path (a): stats lines {[ln.get('step') for ln in stats]}")
            for ln in stats:
                vals = [ln.get(k) for k in ("kinetic", "potential",
                                            "total_energy", "mean_radius")]
                if any(v is None or not np.isfinite(v) for v in vals) \
                        or ln["potential"] >= 0:
                    fail(f"pm path (a): diagnostics line {ln}")
        r0 = float(np.linalg.norm(start, axis=1).mean())
        r1 = float(np.linalg.norm(p_end, axis=1).mean())
        diag_note = ""
        if tag == "a":
            diag_note = (", total energy " + " ".join(
                f"{ln['total_energy']:.6g}" for ln in stats))
        print(f"phase 12 pm main path ({tag}): cli {n_pm} x {steps_} steps "
              f"in {wall:.2f} s, mean radius {r0:.4f} -> {r1:.4f}, "
              f"|P| / sum m|v| {mom_rel:.3g}, centre of mass moved "
              f"{com_shift:.3g}, {len(pngs)} frames, launches {got}"
              f"{diag_note}")
    # the deposit and gather kernels at the path's own shape and data: the
    # final state of run (b) with its masses (after the collapse much of
    # the cloud has left the box and is clamped onto its faces and edges)
    p_end, v_end, c_end, m_end = pm_runs["b"][4]
    b_state = ParticleState.from_arrays(p_end, v_end, c_end, device=dev)
    b_pos = b_state.pos.reshape(3, -1)
    b_masses = torch.ones(b_pos.shape[1], dtype=torch.float32, device=dev)
    b_masses[:n_pm] = torch.from_numpy(m_end).to(dev)
    check_pm("cli (b) final state", b_pos, b_state.n_active, PMConfig(),
             masses=b_masses, exact_ref=True)
    pm_launches = {k: pm_runs["a"][0][k] + pm_runs["b"][0][k]
                   for k in ("pm_deposit", "pm_deposit_mass", "pm_gather")}

    # -- phase 13: times of the PM kernels and layers -----------------------------------
    pm_timing = {}
    cfg = PMConfig()
    g = cfg.grid
    # dt = 0: the timed steps do the same work on the same state (with a
    # time step, G = 1 and N unit masses collapse the shell within the
    # timing and the deposit slows as the cells fill)
    pv_pm = torch.from_numpy(SimParams(delta_time=0.0).pack()).to(dev)
    pp_pm = torch.from_numpy(PairwiseParams(1.0, cfg.softening).pack()).to(dev)
    for label, st, masses_t in (("n=1000000", states[1_000_000], None),
                                ("n=16777216", states[16_777_216], None),
                                ("cli (b) final state n=1000000, masses",
                                 b_state, b_masses)):
        posn, na = st.pos.reshape(3, -1), st.n_active
        n = posn.shape[1]
        box_t, cell_t = pm_cuda.static_box(tuple(cfg.box_min),
                                           float(cfg.cell_size), dev)
        big = n > 2_000_000
        inner = 3 if big else 10
        idx, w = cic_corners(posn, na, box_t, cell_t, g, False, masses_t)
        idx_f, w_f = idx.reshape(-1), w.reshape(-1).contiguous()
        pdk_ms, pdp_ms, pdl_ms = median_ms(
            [lambda: pm_cuda.deposit(posn, na, box_t, cell_t, g,
                                     periodic=False, masses=masses_t),
             lambda: pm_cuda.deposit_plain(posn, na, box_t, cell_t, g,
                                           periodic=False, masses=masses_t),
             lambda: torch.zeros(g ** 3, device=dev).index_put_(
                 (idx_f,), w_f, accumulate=True)],
            reps=5, inner=inner, lead_ms=inner * (4.0 if big else 0.5))
        rho = pm_cuda.deposit(posn, na, box_t, cell_t, g, periodic=False,
                              masses=masses_t)
        grids = pm.solve_accel(rho, cfg, cfg.softening)
        cc = pm.cell_coords_dyn(posn, box_t, cell_t, g, False)
        norm = (cc / (g - 1) * 2.0 - 1.0).T.reshape(1, 1, 1, n, 3)
        norm = norm.contiguous()
        lib_grids = grids[None]
        pgl_max = float((torch.nn.functional.grid_sample(
            lib_grids, norm, mode="bilinear", padding_mode="border",
            align_corners=True).reshape(3, n)[:, :int(na)]
            - pm_cuda.gather(grids, posn, na, box_t, cell_t,
                             periodic=False)[:, :int(na)]).abs().max())
        pgk_ms, pgp_ms, pgl_ms = median_ms(
            [lambda: pm_cuda.gather(grids, posn, na, box_t, cell_t,
                                    periodic=False),
             lambda: pm_cuda.gather_plain(grids, posn, na, box_t, cell_t,
                                          periodic=False),
             lambda: torch.nn.functional.grid_sample(
                 lib_grids, norm, mode="bilinear", padding_mode="border",
                 align_corners=True)],
            reps=5, inner=inner, lead_ms=inner * (4.0 if big else 0.5))
        pd_bound = bytes_ms(n * (12 + (0 if masses_t is None else 4))
                           + 4 * g ** 3)
        pg_bound = bytes_ms(n * 24 + 12 * g ** 3)
        pm_timing[label] = (pdk_ms, pdp_ms, pdl_ms, pd_bound, pgk_ms, pgp_ms,
                            pgl_ms, pg_bound)
        print(f"phase 13 pm deposit {label} G={g}: kernel {pdk_ms:.5f} ms | "
              f"plain {pdp_ms:.5f} ms | index_put_ of the 8N corner weights "
              f"{pdl_ms:.5f} ms | bound {pd_bound:.5f} ms "
              f"({pd_bound / pdk_ms:.1%})")
        print(f"phase 13 pm gather {label} G={g}: kernel {pgk_ms:.5f} ms | "
              f"plain {pgp_ms:.5f} ms | grid_sample (trilinear, "
              f"align_corners; max |diff| {pgl_max:.3g}) {pgl_ms:.5f} ms | "
              f"bound {pg_bound:.5f} ms ({pg_bound / pgk_ms:.1%})")
        if masses_t is not None:
            continue
        # the PM step's layers (device times), and the sort the TPU design
        # pays and this one does not
        acc = pm_cuda.gather(grids, posn, na, box_t, cell_t, periodic=False)
        keys = idx[0].to(torch.int32)          # the lower corner's cell
        pk, vk = st.pos.clone(), st.vel.clone()
        layers = median_ms(
            [lambda: pm_cuda.deposit(posn, na, box_t, cell_t, g,
                                     periodic=False),
             lambda: pm.solve_accel(rho, cfg, cfg.softening),
             lambda: pm_cuda.gather(grids, posn, na, box_t, cell_t,
                                    periodic=False),
             lambda: pm.momentum_clean(acc, na),
             lambda: step_cuda.step(pk, vk.add_(acc.reshape(vk.shape)
                                                * pv_pm[0]), pv_pm),
             lambda: pm_cuda.step_pm(pk, vk, pv_pm, pp_pm, na, cfg),
             lambda: torch.sort(keys)],
            reps=5, inner=inner, lead_ms=inner * (8.0 if big else 2.0))
        names = ("deposit", "FFT solve", "gather", "momentum_clean",
                 "kick + step", "whole PM step", "torch.sort of N int32 "
                 "cell keys (not on the path)")
        print(f"  layers {label} G={g}: " + " | ".join(
            f"{nm} {ms:.5f} ms" for nm, ms in zip(names, layers)))

    # -- phase 14: the tensor-core all-pairs force -----------------------------
    t0 = time.perf_counter()
    mx_g, mx_eps = 2.5, 0.5
    mx_cases = [("square", x, x, N_GRAVITY, 0),
                ("60000 active, poisoned padding", poisoned, poisoned,
                 60_000, 0),
                ("65536 x 32768, j_base 32768", x, x[:, half:].contiguous(),
                 N_GRAVITY, half),
                ("32768 x 65536", x[:, :half].contiguous(), x, N_GRAVITY, 0),
                ("1000 x 777, 700 active", x[:, :1000].contiguous(),
                 x[:, :777].contiguous(), 700, 0)]
    # the drive: every case once through the kernel's wrapper
    pairwise_cuda.MXU_LAUNCHES = 0
    mx_got = [pairwise_cuda.pairwise_accel_mxu(xi_, xj_, na, mx_g, mx_eps,
                                               j_base=jb)
              for _, xi_, xj_, na, jb in mx_cases]
    torch.cuda.synchronize()
    mx_launches = pairwise_cuda.MXU_LAUNCHES
    if mx_launches != len(mx_cases):
        fail(f"pairwise_mxu: {mx_launches} launches for {len(mx_cases)} "
             f"calls")
    mx_rel = 0.0
    for (label, xi_, xj_, na, jb), got in zip(mx_cases, mx_got):
        want = pairwise.pairwise_accel_mxu_ref(xi_, xj_, na, mx_g, mx_eps,
                                               j_base=jb)
        direct = pairwise_cuda.pairwise_accel(xi_.T, xj_, na, mx_g, mx_eps,
                                              j_base=jb).T
        torch.cuda.synchronize()
        # both are the expanded f32 form: the bar is twice the plain
        # version's own distance from the direct sum (the pairwise kernel)
        plain_err = float((want - direct).abs().max())
        e = check_close(f"pairwise_mxu {label}", got, want, 0.0,
                        2.0 * plain_err)
        err["pairwise_mxu"] = max(err["pairwise_mxu"], e)
        rel = float(((got - direct).abs() / (direct.abs() + 1e-2)).max())
        rel_plain = float(((want - direct).abs()
                           / (direct.abs() + 1e-2)).max())
        rel_norm = float(((got - direct).norm(dim=0)
                          / (direct.norm(dim=0) + 1e-2)).max())
        if not rel < 0.05:
            fail(f"pairwise_mxu {label}: max |dA| / (|A| + 1e-2) {rel:.4g} "
                 f"against the pairwise kernel (bar 0.05)")
        mx_rel = max(mx_rel, rel)
        print(f"  pairwise_mxu {label}: max |k - p| {e:.3g} (bar "
              f"{2.0 * plain_err:.3g}, max|p| {float(want.abs().max()):.4g});"
              f" against the pairwise kernel max |dA| / (|A| + 1e-2) "
              f"{rel:.4g} a component (plain {rel_plain:.4g}), "
              f"{rel_norm:.3g} a particle (|dA| / (|A| + 1e-2))")
    # the plain version's error on the square case, split by its source
    direct = pairwise_cuda.pairwise_accel(x.T, x, N_GRAVITY, mx_g, mx_eps).T
    budget = []
    for r2_dt, s_dt in ((torch.float32, torch.float32),
                        (torch.float64, torch.float32),
                        (torch.float32, torch.float64)):
        a = mxu_plain_split(x, x, mx_g, mx_eps, r2_dt, s_dt)
        budget.append(float(((a - direct).abs()
                             / (direct.abs() + 1e-2)).max()))
    print(f"  pairwise_mxu plain version's error, square case, max |dA| / "
          f"(|A| + 1e-2) against the pairwise kernel: f32 throughout "
          f"{budget[0]:.4g}; r^2 in float64 {budget[1]:.4g}; S in float64 "
          f"{budget[2]:.4g}")
    mx_sass = sass_counts(path, "pairwise_mxu_kernel")
    if mx_sass["hmma"] == 0:
        fail(f"pairwise_mxu: no HMMA in its SASS ({mx_sass})")
    mx_ms, mxd_ms, mxo_ms = median_ms(
        [lambda: pairwise_cuda.pairwise_accel_mxu(x, x, N_GRAVITY, mx_g,
                                                  mx_eps),
         lambda: pairwise_cuda.pairwise_accel(x.T, x, N_GRAVITY, mx_g,
                                              mx_eps),
         lambda: (pairwise_cuda.hilbert_order(x),
                  pairwise_cuda.inlier_box(x))],
        reps=7, inner=5, lead_ms=5 * 8.0)
    (mxp_ms,) = median_ms(
        [lambda: pairwise.pairwise_accel_mxu_ref(x, x, N_GRAVITY, mx_g,
                                                 mx_eps)], reps=3, inner=1)
    mx_fp32 = MXU_PAIR_FP32_INSTRS * pairs / FP32_INSTRS_PER_S * 1e3
    mx_rsqrt = pairs / RSQRT_PER_S * 1e3
    mx_tc = MXU_PAIR_TC_FLOPS * pairs / TF32_FLOPS_PER_S * 1e3
    mx_bound = max(mx_fp32, mx_rsqrt, mx_tc)
    print(f"phase 14 pairwise_mxu at {N_GRAVITY}: {len(mx_cases)} cases, "
          f"max |k - p| {err['pairwise_mxu']:.3g}, against the pairwise "
          f"kernel max {mx_rel:.4g} a component (bar 0.05); SASS "
          f"{mx_sass['hmma']} HMMA, {mx_sass['rsq']} MUFU.RSQ, "
          f"{mx_sass['fp32']} FP32 ({time.perf_counter() - t0:.1f} s)")
    print(f"phase 14 pairwise_mxu {N_GRAVITY}^2: kernel {mx_ms:.4f} ms "
          f"({pairs / mx_ms * 1e3:.4g} pairs/s, {mx_bound / mx_ms:.1%} of the "
          f"bound; of it the wrapper's Hilbert order and inlier box "
          f"{mxo_ms:.4f} ms) | pairwise kernel {mxd_ms:.4f} ms | plain "
          f"{mxp_ms:.3f} ms "
          f"| bound {mx_bound:.4f} ms (largest of: {MXU_PAIR_FP32_INSTRS} "
          f"FP32 instructions/pair at 128/SM/clock {mx_fp32:.4f} ms; rsqrt "
          f"at 16/SM/clock {mx_rsqrt:.4f} ms; {MXU_PAIR_TC_FLOPS} TF32 "
          f"tensor-core flops/pair at 495 TFLOP/s {mx_tc:.4f} ms) | "
          f"library: none")

    # -- phase 15: the merge sort -----------------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(15)

    def pm_sort_words(st, masses=None):
        """pm_pallas.pm_sort's operands at G = 128 (static box): cell key
        (dead particles: G^3), original index, 10-bit fractions packed in
        one int32[, mass]."""
        cfg = PMConfig()
        g = cfg.grid
        posf = st.pos.reshape(3, -1)
        c = pm.cell_coords_dyn(posf, cfg.box_min, cfg.cell_size, g, False)
        fl = torch.floor(c)
        i0, fq = fl.to(torch.int32), torch.round((c - fl) * 1023.0).to(
            torch.int32)
        idx = torch.arange(posf.shape[1], dtype=torch.int32, device=dev)
        key = torch.where(idx < st.n_active,
                          (i0[2] * g + i0[1]) * g + i0[0], g ** 3)
        words = [key, idx, fq[0] | (fq[1] << 10) | (fq[2] << 20)]
        return words + ([masses] if masses is not None else [])

    def u32(v):
        """uint32 tensor of int64 values in [0, 2^32)."""
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(
            torch.int32).view(torch.uint32)

    def dev_words(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    pm1 = pm_sort_words(states[1_000_000])
    pm16 = pm_sort_words(states[16_777_216])
    m1 = torch.from_numpy((rng.random(pm1[0].shape[0]) + 0.5).astype(
        np.float32)).to(dev)
    # the un-sort words: idx_s << 8 | 8 bits of exponent and mantissa, and
    # one 32-bit word (2^24 particles reach keys of 2^32 - 1); above 2^24
    # particles the un-sort carries idx and the three f32 accelerations
    fwd16 = torch.sort(pm16[0], stable=True).indices.to(torch.int32)
    uns16 = [u32((fwd16.long() << 8) | torch.randint(
                 0, 256, fwd16.shape, device=dev)),
             u32(torch.randint(0, 1 << 32, fwd16.shape, device=dev))]
    fwd1 = torch.sort(pm1[0], stable=True).indices.to(torch.int32)
    uns1 = [fwd1] + list(torch.randn((3, fwd1.shape[0]), device=dev))
    tk = raster.tile_keys(*frame_args(states[1_000_000],
                                      SimParams(color_mode=1),
                                      Camera(aspect=1280 / 720)),
                          width=1280, height=720).key
    sort_cases = [
        ("PM forward sort 1M (key, idx, frac)", pm1),
        ("PM forward sort 1M with mass", pm1 + [m1]),
        ("PM forward sort 16M (key, idx, frac)", pm16),
        ("PM un-sort 16M (2 x uint32)", uns16),
        ("PM un-sort 1M (idx, 3 x f32)", uns1),
        ("raster tile keys 1M @ 1280x720 + index", [tk, torch.arange(
            tk.shape[0], dtype=torch.int32, device=dev)])]
    n_d = 131_072                 # tests/test_psort.py's distributions
    r2 = np.random.default_rng(2)
    dists = {
        "duplicates": r2.integers(0, 50, n_d),
        "all_equal": np.full(n_d, 7),
        "sorted": np.sort(r2.integers(0, 1 << 30, n_d)),
        "reversed": np.sort(r2.integers(0, 1 << 30, n_d))[::-1],
        "clustered": (r2.integers(0, 4, n_d) * (1 << 28)
                      + r2.integers(0, 100, n_d))}
    tail = np.sort(r2.integers(0, 1 << 21, n_d))
    tail[n_d // 2:] = 0xFFFFFFFF
    r2.shuffle(tail)
    dists["sentinel_tail"] = tail
    for name, keys in dists.items():
        sort_cases.append((f"{name} {n_d}", dev_words(
            keys.astype(np.uint32), np.arange(n_d, dtype=np.int32))))
    for n in (1_000_448, 80_000):
        sort_cases.append((f"ragged {n}", dev_words(
            rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
            np.arange(n, dtype=np.int32))))
    big = rng.integers(1 << 31, 1 << 32, 1_000_000, dtype=np.uint64)
    big[rng.random(big.shape[0]) < 0.01] = 0xFFFFFFFF
    sort_cases.append(("uint32 keys >= 2^31 with key max 1M", dev_words(
        big.astype(np.uint32), np.arange(big.shape[0], dtype=np.int32))))

    def rounds(n):
        r, run = 0, psort.SEG
        while run < n:
            r, run = r + 1, run * 2
        return r

    # the drive: every case once through psort.sort
    psort.BLOCK_LAUNCHES = psort.MERGE_LAUNCHES = psort.LIBRARY_CALLS = 0
    sorted_out = [psort.sort(ops) for _, ops in sort_cases]
    torch.cuda.synchronize()
    sort_launches = {"block_sort": psort.BLOCK_LAUNCHES,
                     "merge_round": psort.MERGE_LAUNCHES}
    want_launches = {"block_sort": len(sort_cases), "merge_round": sum(
        rounds(ops[0].shape[0]) for _, ops in sort_cases)}
    if sort_launches != want_launches or psort.LIBRARY_CALLS:
        fail(f"sort: launches {sort_launches}, expected {want_launches}; "
             f"torch.sort route taken {psort.LIBRARY_CALLS} times")
    for (label, ops), got in zip(sort_cases, sorted_out):
        order = torch.sort(psort.ordered_key(ops[0]), stable=True).indices
        plain = psort.sort_ref(ops)
        for w, (o, g_, p_) in enumerate(zip(ops, got, plain)):
            gi = g_.view(torch.int32)
            if not torch.equal(gi, p_.view(torch.int32)):
                fail(f"sort {label}: word {w} differs from plain")
            if not torch.equal(gi, o.view(torch.int32)[order]):
                fail(f"sort {label}: word {w} differs from a stable "
                     f"torch.sort")
        # the first and last key (an int32 key's order value is key + 2^31)
        k = psort.ordered_key(got[0])[[0, -1]] - (
            1 << 31 if got[0].dtype == torch.int32 else 0)
        print(f"  sort {label}: n {ops[0].shape[0]}, {len(ops)} words, "
              f"{ops[0].dtype}, keys {int(k[0])}..{int(k[1])}, "
              f"{rounds(ops[0].shape[0])} merge rounds: == plain, == stable "
              f"torch.sort")
    # outside the contract: the torch.sort route, counted
    lib_k = dev_words(rng.integers(0, 4, 5000).astype(np.uint32),
                      rng.integers(0, 4, 5000).astype(np.uint32))
    two = psort.sort(lib_k, num_keys=2)
    f64 = psort.sort([lib_k[0], torch.arange(5000, dtype=torch.float64,
                                             device=dev)])
    two_key = psort.ordered_key(two[0]) * 4 + psort.ordered_key(two[1])
    if psort.LIBRARY_CALLS != 2 or not bool((two_key[1:] >= two_key[:-1])
                                            .all()) \
            or f64[1].dtype != torch.float64:
        fail(f"sort: torch.sort route ({psort.LIBRARY_CALLS} calls)")

    def lib_sort(ops, width=None):
        """One torch.sort of the key (of each full row of ``width`` when
        given: the block sort's function), the payloads gathered by its
        indices."""
        key = ops[0] if ops[0].dtype == torch.int32 else psort.ordered_key(
            ops[0])
        n_use = key.shape[0] if width is None else (
            key.shape[0] // width * width)
        key = key[:n_use].view(-1, width or n_use)
        order = torch.sort(key, dim=-1).indices
        return [torch.take_along_dim(o[:n_use].view(torch.int32).view(
            key.shape), order, -1) for o in ops[1:]]

    sort_timing = {}
    for label, ops in (("1M", pm1), ("16M", pm16)):
        n, words = ops[0].shape[0], len(ops)
        big_ = n > 2_000_000
        blk = psort.block_sort(ops)
        # the last round's input: runs [0, L) and [L, n) sorted
        last_run = psort.SEG << (rounds(n) - 1)
        halves = [psort.sort([o[:last_run] for o in ops]),
                  psort.sort([o[last_run:] for o in ops])]
        last_in = [torch.cat([a, b]) for a, b in zip(*halves)]
        inner = 3 if big_ else 10
        b_ms, m1_ms, ml_ms, s_ms, bl_ms, ml_lib_ms, sl_ms = median_ms(
            [lambda: psort.block_sort(ops),
             lambda: psort.merge_round(blk, psort.SEG),
             lambda: psort.merge_round(last_in, last_run),
             lambda: psort.sort(ops),
             lambda: lib_sort(ops, psort.SEG),
             lambda: lib_sort(last_in),
             lambda: lib_sort(ops)],
            reps=5, inner=inner, lead_ms=inner * (6.0 if big_ else 0.5))
        bp_ms, mlp_ms, sp_ms = median_ms(
            [lambda: psort.block_sort_ref(ops),
             lambda: psort.merge_round_ref(last_in, last_run),
             lambda: psort.sort_ref(ops)], reps=3, inner=1)
        launch_bound = bytes_ms(8 * words * n)   # every word read + written
        r = rounds(n)
        sort_timing[label] = dict(block=b_ms, block_plain=bp_ms,
                                  block_lib=bl_ms, merge=ml_ms,
                                  merge_plain=mlp_ms, merge_lib=ml_lib_ms,
                                  bound=launch_bound)
        print(f"phase 15 sort {label} PM forward-sort words ({words} x "
              f"int32, n {n}): block sort {b_ms:.4f} ms (plain {bp_ms:.3f}, "
              f"torch.sort of the full {psort.SEG}-rows + gather "
              f"{bl_ms:.4f}) | merge "
              f"round L={psort.SEG} {m1_ms:.4f} ms, L={last_run} {ml_ms:.4f} "
              f"ms (plain {mlp_ms:.3f}, torch.sort + gather {ml_lib_ms:.4f}) "
              f"| whole sort ({r} rounds) {s_ms:.4f} ms (plain {sp_ms:.3f}) | "
              f"torch.sort(key) + index_select {sl_ms:.4f} ms | bound a "
              f"launch {launch_bound:.4f} ms, the sort "
              f"{(1 + r) * launch_bound:.4f} ms (bytes)")
    print(f"phase 15 sort: {len(sort_cases)} cases == plain and == stable "
          f"torch.sort, launches {sort_launches}, torch.sort route only "
          f"outside the contract ({time.perf_counter() - t0:.1f} s)")

    src = "particle_sim_tpu_torch/csrc/"
    kernels = [
        {"name": "step", "route": "cuda", "source": src + "step.cu",
         "replaces": "particle_sim_tpu/ops/step_pallas.py:38",
         "launches": launches["step"], "max_abs_err": err["step"],
         "ms": timing[1_000_000][0], "plain_ms": timing[1_000_000][1],
         "bound_ms": bytes_ms(STEP_BYTES * 1_000_000), "bound_by": "bytes",
         "library_ms": None},
        {"name": "compact", "route": "cuda",
         "source": src + "raster_compact.cu",
         "replaces": "particle_sim_tpu/render/raster_compact.py:165",
         "launches": launches["compact"], "max_abs_err": err["compact"],
         "ms": ck_ms, "plain_ms": cp_ms, "bound_ms": c_bound,
         "bound_by": "bytes", "library_ms": cl_ms},
        {"name": "deposit", "route": "cuda",
         "source": src + "raster_compact.cu",
         "replaces": "particle_sim_tpu/render/raster_compact.py:85",
         "launches": launches["deposit"], "max_abs_err": err["deposit"],
         "ms": dk_ms, "plain_ms": dp_ms, "bound_ms": d_bound,
         "bound_by": "bytes", "library_ms": dl_ms},
        {"name": "pairwise", "route": "cuda", "source": src + "pairwise.cu",
         "replaces": "particle_sim_tpu/ops/pairwise_pallas.py:54",
         "launches": g_launches["pairwise"], "max_abs_err": err["pairwise"],
         "ms": pw_ms, "plain_ms": pwp_ms, "bound_ms": pw_bound,
         "bound_by": "operations", "library_ms": None},
        {"name": "sorted_deposit", "route": "cuda",
         "source": src + "raster_sorted.cu",
         "replaces": "particle_sim_tpu/render/raster_sorted.py:47",
         "launches": g_launches["sorted_deposit"],
         "max_abs_err": err["sorted_deposit"],
         "ms": sd_timing[1_000_000][0], "plain_ms": sd_timing[1_000_000][1],
         "bound_ms": sd_timing[1_000_000][3], "bound_by": "bytes",
         "library_ms": sd_timing[1_000_000][2]},
        # one CUDA template: the unit-mass instantiation replaces :247, the
        # mass one _deposit_kernel_mass (:253); launches of both, phase 12
        {"name": "pm_deposit", "route": "cuda", "source": src + "pm.cu",
         "replaces": "particle_sim_tpu/ops/pm_pallas.py:247",
         "launches": pm_launches["pm_deposit"]
         + pm_launches["pm_deposit_mass"],
         "max_abs_err": err["pm_deposit"],
         "ms": pm_timing["n=1000000"][0],
         "plain_ms": pm_timing["n=1000000"][1],
         "bound_ms": pm_timing["n=1000000"][3], "bound_by": "bytes",
         "library_ms": pm_timing["n=1000000"][2]},
        {"name": "pm_gather", "route": "cuda", "source": src + "pm.cu",
         "replaces": "particle_sim_tpu/ops/pm_pallas.py:259",
         "launches": pm_launches["pm_gather"],
         "max_abs_err": err["pm_gather"],
         "ms": pm_timing["n=1000000"][4],
         "plain_ms": pm_timing["n=1000000"][5],
         "bound_ms": pm_timing["n=1000000"][7], "bound_by": "bytes",
         "library_ms": pm_timing["n=1000000"][6]},
        {"name": "pairwise_mxu", "route": "cuda",
         "source": src + "pairwise_mxu.cu",
         "replaces": "particle_sim_tpu/ops/pairwise_pallas.py:179",
         "launches": mx_launches, "max_abs_err": err["pairwise_mxu"],
         "ms": mx_ms, "plain_ms": mxp_ms, "bound_ms": mx_bound,
         "bound_by": "operations", "library_ms": None},
        # both at the 16M PM forward-sort words; merge_round: the last
        # round (two runs of 8M)
        {"name": "block_sort", "route": "cuda", "source": src + "psort.cu",
         "replaces": "particle_sim_tpu/ops/psort.py:232",
         "launches": sort_launches["block_sort"],
         "max_abs_err": err["sort"], "ms": sort_timing["16M"]["block"],
         "plain_ms": sort_timing["16M"]["block_plain"],
         "bound_ms": sort_timing["16M"]["bound"], "bound_by": "bytes",
         "library_ms": sort_timing["16M"]["block_lib"]},
        {"name": "merge_round", "route": "cuda", "source": src + "psort.cu",
         "replaces": "particle_sim_tpu/ops/psort.py:289",
         "launches": sort_launches["merge_round"],
         "max_abs_err": err["sort"], "ms": sort_timing["16M"]["merge"],
         "plain_ms": sort_timing["16M"]["merge_plain"],
         "bound_ms": sort_timing["16M"]["bound"], "bound_by": "bytes",
         "library_ms": sort_timing["16M"]["merge_lib"]},
    ]
    print(gpu_name_and_limit())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
