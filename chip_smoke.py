#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (particle_sim_tpu_torch) on one
NVIDIA GPU: builds the hand-written kernels, holds each against its plain
PyTorch version, drives the headless CLI at 1M particles, and times the
kernels.

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
  5. times with CUDA events (medians after warm-up), kernel vs plain; the
     kernel-level times queue the calls behind a GPU spin, so they are
     device times; the frame times include the host (one read per frame)

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
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
STEP_BYTES = 48                # 6 floats read + 6 written per particle-step


def fail(msg: str) -> None:
    raise AssertionError(msg)


def check_close(name, got, want, rtol, atol) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere.
    -> max absolute error."""
    import torch

    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    if bad.any():
        i = int(bad.reshape(-1).nonzero()[0])
        fail(f"{name}: {int(bad.sum())} elements outside rtol={rtol} "
             f"atol={atol}; first at {i}: {float(got.reshape(-1)[i])} vs "
             f"{float(want.reshape(-1)[i])}")
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


def cargs_of(words):
    return (words.key, words.rg, words.b, words.kept_list, words.kept_n)


def bucket_of(words, rc) -> int:
    """The bucket the renderer picks for these point words."""
    kept = int(words.kept_n.item()) * rc.CHUNK
    return next(bb for bb in rc.buckets(words.key.shape[0]) if kept <= bb)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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

    from particle_sim_tpu_torch.app import cli
    from particle_sim_tpu_torch.core import generate as gen
    from particle_sim_tpu_torch.core.params import SimParams
    from particle_sim_tpu_torch.core.state import ParticleState
    from particle_sim_tpu_torch.ops import step_cuda
    from particle_sim_tpu_torch.render import raster, raster_compact as rc
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
            if "registers" in ln] if log.exists() else []
    print(f"phase 1 build: {os.path.relpath(path, ROOT)} in {secs:.2f} s "
          f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for ln in regs:
        print(f"  ptxas: {ln}")

    err = {"step": 0.0, "compact": 0.0, "deposit": 0.0}
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
        st = states[n]
        pv = torch.from_numpy(SimParams(color_mode=1).pack()).to(dev)
        vp = torch.from_numpy(Camera(aspect=w / h).view_proj()).to(dev)
        args = (st.pos, st.vel, st.init_color, pv, vp, st.n_active)
        words = rc.point_words(*args, width=w, height=h)
        kept = int(words.kept_n.item()) * rc.CHUNK
        bucket, cargs = bucket_of(words, rc), cargs_of(words)
        ck = rc.compact(*cargs, bucket=bucket, sentinel=words.sentinel)
        cp = rc.compact_plain(*cargs, bucket=bucket, sentinel=words.sentinel)
        for a, b in zip(ck, cp):
            if not torch.equal(a, b):
                fail(f"compact n={n}: kernel differs from plain")
        pt = rc.pair_table(*ck, n_tiles=words.n_tiles,
                           sentinel=words.sentinel)
        dargs = (pt.table, pt.offsets, pt.key, pt.rg, pt.b)
        dk = rc.deposit(*dargs, n_tiles=words.n_tiles)
        dp = rc.deposit_plain(*dargs, n_tiles=words.n_tiles)
        err["deposit"] = max(err["deposit"], check_close(
            f"deposit n={n} {w}x{h}", dk, dp, 1e-4, 1e-5))
        fk = rc.render(*args, width=w, height=h)
        fp = rc.render(*args, width=w, height=h, plain=True)
        check_close(f"compact frame n={n} {w}x{h}", fk, fp, 1e-4, 1e-5)
        u8 = (raster.to_rgba8(fk).int() - raster.to_rgba8(fp).int()).abs()
        if int(u8.max()) > 1:
            fail(f"frame n={n}: u8 frames differ by {int(u8.max())}")
        lit = int((fk.sum(-1) > 0).sum())
        if lit < 1000:
            fail(f"frame n={n}: only {lit} lit pixels")
        print(f"  n={n} {w}x{h}: kept {kept} of {words.key.shape[0]} points "
              f"(bucket {bucket}), table {pt.table.shape[0]} entries, "
              f"{lit} lit pixels")
        if n == 1_000_000:
            main_inputs = (cargs, bucket, words, dargs)
    # the golden frame, through the kernels
    pos, vel, col = gen.generate(3000)
    vel = (pos * 0.02).astype(np.float32)
    gst = ParticleState.from_arrays(pos, vel, col, device=dev)
    gfb = rc.render(gst.pos, gst.vel, gst.init_color,
                    torch.from_numpy(SimParams().pack()).to(dev),
                    torch.from_numpy(Camera(aspect=2.0).view_proj()).to(dev),
                    gst.n_active, width=256, height=128)
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

    # -- phase 5: times -----------------------------------------------------------
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
        roof = STEP_BYTES * n / HBM_BYTES_PER_S * 1e3
        print(f"phase 5 step n={n}: kernel {k_ms:.5f} ms "
              f"({n / k_ms * 1e3:.4g} particle-steps/s, "
              f"{roof / k_ms:.1%} of the 3.35 TB/s HBM roofline) | plain "
              f"{p_ms:.5f} ms ({n / p_ms * 1e3:.4g} particle-steps/s, "
              f"{roof / p_ms:.1%})")
    cargs, bucket, words, dargs = main_inputs
    ck_ms, cp_ms = median_ms(
        [lambda: rc.compact(*cargs, bucket=bucket, sentinel=words.sentinel),
         lambda: rc.compact_plain(*cargs, bucket=bucket,
                                  sentinel=words.sentinel)], inner=20,
        lead_ms=20 * 0.3)
    dk_ms, dp_ms = median_ms(
        [lambda: rc.deposit(*dargs, n_tiles=words.n_tiles),
         lambda: rc.deposit_plain(*dargs, n_tiles=words.n_tiles)], inner=5,
        lead_ms=5 * 0.5)
    print(f"phase 5 compact 1M@1280x720: kernel {ck_ms:.5f} ms | plain "
          f"{cp_ms:.5f} ms")
    print(f"phase 5 deposit 1M@1280x720: kernel {dk_ms:.5f} ms | plain "
          f"{dp_ms:.5f} ms")
    # frames: the random-velocity states of phases 2-3 (every point lit),
    # and the main path's own final state (lit only where the mouse pulled)
    for label, st, w, h in (("n=1000000", states[1_000_000], 1280, 720),
                            ("n=16777216", states[16_777_216], 1920, 1080),
                            ("cli final state n=1000000", cli_state, 1280,
                             720)):
        args = (st.pos, st.vel, st.init_color,
                torch.from_numpy(SimParams(color_mode=1).pack()).to(dev),
                torch.from_numpy(Camera(aspect=w / h).view_proj()).to(dev),
                st.n_active)
        fk_ms, fp_ms, fs_ms = median_ms(
            [lambda: rc.render(*args, width=w, height=h),
             lambda: rc.render(*args, width=w, height=h, plain=True),
             lambda: raster.render(*args, width=w, height=h)], inner=3)
        print(f"phase 5 frame {label} {w}x{h}: compact (kernels) "
              f"{fk_ms:.4f} ms"
              f" | compact (plain) {fp_ms:.4f} ms | scatter (plain) "
              f"{fs_ms:.4f} ms")
        # the compact frame's layers, one at a time
        words = rc.point_words(*args, width=w, height=h)
        bucket = bucket_of(words, rc)
        ck = rc.compact(*cargs_of(words), bucket=bucket,
                        sentinel=words.sentinel)
        pt = rc.pair_table(*ck, n_tiles=words.n_tiles,
                           sentinel=words.sentinel)
        layers = median_ms(
            [lambda: rc.point_words(*args, width=w, height=h),
             lambda: words.kept_n.item(),
             lambda: rc.compact(*cargs_of(words), bucket=bucket,
                                sentinel=words.sentinel),
             lambda: rc.pair_table(*ck, n_tiles=words.n_tiles,
                                   sentinel=words.sentinel),
             lambda: rc.deposit(pt.table, pt.offsets, pt.key, pt.rg, pt.b,
                                n_tiles=words.n_tiles)],
            inner=3, lead_ms=10.0)
        print(f"  layers (kept {int(words.kept_n.item()) * rc.CHUNK} "
              f"points): " + " | ".join(
            f"{name} {ms:.4f} ms" for name, ms in zip(
                ("point_words", "kept_n host read", "compact",
                 "pair_table", "deposit"), layers)))

    src = "particle_sim_tpu_torch/csrc/"
    kernels = [
        {"name": "step", "route": "cuda", "source": src + "step.cu",
         "replaces": "particle_sim_tpu/ops/step_pallas.py:38",
         "launches": launches["step"], "max_abs_err": err["step"],
         "ms": timing[1_000_000][0], "plain_ms": timing[1_000_000][1]},
        {"name": "compact", "route": "cuda",
         "source": src + "raster_compact.cu",
         "replaces": "particle_sim_tpu/render/raster_compact.py:165",
         "launches": launches["compact"], "max_abs_err": err["compact"],
         "ms": ck_ms, "plain_ms": cp_ms},
        {"name": "deposit", "route": "cuda",
         "source": src + "raster_compact.cu",
         "replaces": "particle_sim_tpu/render/raster_compact.py:85",
         "launches": launches["deposit"], "max_abs_err": err["deposit"],
         "ms": dk_ms, "plain_ms": dp_ms},
    ]
    print(gpu_name_and_limit())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
