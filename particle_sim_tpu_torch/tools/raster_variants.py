"""Time the candidate designs of the two frame deposits (the sorted
renderer's and the compact renderer's) in turns, on one card.

    python3 -m particle_sim_tpu_torch.tools.raster_variants  # repo root, one GPU

Builds ``raster_variants.cu`` with nvcc into ``build/raster_variants/``,
once a config in ``CONFIGS`` (all nvcc runs started together). The file
holds the earlier kernels, verbatim, as variant 0 (one block per tile),
includes the package's kernels (``csrc/raster_sorted.cu`` and the deposit
of ``csrc/raster_compact.cu``), which each config builds with other -D
knobs of ``csrc/tile_runs.cuh`` (groups a warp, blocks an SM, 16-byte
loads), and adds a shared-memory alternative (a window of tiles a block
that merges its runs before they reach the frame). On four inputs

  * 1M hollow-sphere points @ 1280x720 and 16,777,216 @ 1920x1080 (random
    velocities x 3, seed 0, velocity colour, the default camera),
  * the attractor CLI's final state (1M, 600 steps of the orbiting dragged
    mouse, as chip_smoke.py's phase 4 runs it) @ 1280x720,
  * a contended frame: 1,048,576 points in one tile of a 1280x720 frame,
    about 1,024 a pixel,

it checks every variant against the plain versions (``deposit_plain`` of
``render/raster_sorted.py`` and ``render/raster_compact.py``): within
1e-5 + 1e-4 |p|, on the contended frame within 2 K u sum|x| a pixel of K
terms (both are f32 sums of the same terms). Then it prints CUDA-event
medians of every variant beside the package's wrappers, a memset of the
frame alone and the bytes bound (each input read once, the frame written
once). Prints each kernel's registers (``ptxas -v``). The numbers also go
to ``build/raster_variants/report.json``. Exits 1 without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
BUILD = ROOT / "build" / "raster_variants"
#: builds of raster_variants.cu: (name, -D flags); the first is the
#: package's own settings and holds variant 0 and the shared windows of 2
#: tiles
CONFIGS = (("the package's settings (1 group a warp; sorted: no "
            "grid-stride loop, compact: as many blocks as fit)", {}),
           ("2 groups a warp", {"RD_GROUPS": 2}),
           ("4 groups a warp (compact: a warp an entry)", {"RD_GROUPS": 4}),
           ("sorted with a grid-stride loop, as many blocks as fit",
            {"SD_BLOCKS_PER_SM": 0}),
           ("compact without a grid-stride loop, a warp a unit",
            {"CD_BLOCKS_PER_SM": -1}),
           ("a grid-stride loop, at most 4 blocks an SM",
            {"SD_BLOCKS_PER_SM": 4, "CD_BLOCKS_PER_SM": 4}),
           ("4-byte loads", {"RD_VEC": 0}),
           ("shared window of 1 tile", {"RV_WINDOW": 1}))
_WINDOW1 = len(CONFIGS) - 1
#: (name, config, export): "v0" the earlier kernels, "pkg" the package's
#: kernels as the config builds them, "window" the shared-window kernels
VARIANTS = ((("v0 earlier: one block a tile", 0, "v0"),)
            + tuple((f"this design, {name}", c, "pkg")
                    for c, (name, _) in enumerate(CONFIGS) if c != _WINDOW1)
            + (("shared window of 2 tiles a block", 0, "window"),
               ("shared window of 1 tile a block", _WINDOW1, "window")))


def start_builds(configs=CONFIGS) -> list:
    """Start one nvcc a config. -> [(name, library path, process)]."""
    from particle_sim_tpu_torch.utils import cuda_build

    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for c, (name, flags) in enumerate(configs):
        out = BUILD / f"libraster_variants{c}.so"
        defs = [f"-D{k}={v}" for k, v in flags.items()]
        jobs.append((name, out, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *defs, "-shared",
             "-o", str(out), str(HERE / "raster_variants.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return jobs


def finish_builds(jobs, *, show_registers: bool = True) -> list:
    """Wait for the builds and load them. -> [ctypes.CDLL] a config."""
    libs = []
    for name, out, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({name}):\n{text}")
        if show_registers:   # registers of the package's kernels (16-byte
            lines = text.splitlines()   # loads), and of variant 0 once
            for k, ln in enumerate(lines):
                if "Compiling entry" in ln and (
                        "deposit_kernelILb1E" in ln
                        or "window" in ln and (not libs or "window" in name)
                        or "v0" in ln and not libs):
                    kern = ln.split("'")[1]
                    regs = next((x for x in lines[k + 1:k + 6]
                                 if "registers" in x), "").split(":")[-1]
                    print(f"  {name}: {kern}:{regs}")
        libs.append(load(out))
    return libs


def load(path) -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(str(path))
    sig = {"probe_v0_sorted": (P, P, P, P, I, I, P),
           "probe_window_sorted": (P, P, P, P, I, I, P),
           "psim_sorted_deposit": (P, P, P, P, I, I, P),
           "probe_v0_deposit": (P, P, P, P, P, P, I, I, P),
           "probe_window_deposit": (P, P, P, P, P, P, I, I, I, P),
           "psim_deposit": (P, P, P, P, P, P, I, I, I, P)}
    for fn, argtypes in sig.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def sorted_call(lib, kind, sp):
    """One launch of a sorted-deposit variant on SortedPoints ``sp``.
    -> f32[n_tiles, 3, 8, 128]."""
    import torch

    out = torch.empty((sp.n_tiles, 3, 8, 128), dtype=torch.float32,
                      device=sp.key.device)
    fn = {"v0": lib.probe_v0_sorted, "pkg": lib.psim_sorted_deposit,
          "window": lib.probe_window_sorted}[kind]
    err = fn(sp.key.data_ptr(), sp.rgb.data_ptr(), sp.offsets.data_ptr(),
             out.data_ptr(), sp.key.shape[0], sp.n_tiles,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sorted deposit ({kind}): CUDA error {err}")
    return out


def compact_call(lib, kind, pt, n_tiles):
    """One launch of a compact-deposit variant on PairTable ``pt``.
    -> f32[n_tiles, 3, 8, 128]."""
    import torch

    out = torch.empty((n_tiles, 3, 8, 128), dtype=torch.float32,
                      device=pt.key.device)
    args = [pt.table.data_ptr(), pt.offsets.data_ptr(), pt.key.data_ptr(),
            pt.rg.data_ptr(), pt.b.data_ptr(), out.data_ptr(), n_tiles,
            pt.key.shape[0] // 512]
    if kind != "v0":
        args.append(pt.table.shape[0])
    fn = {"v0": lib.probe_v0_deposit, "pkg": lib.psim_deposit,
          "window": lib.probe_window_deposit}[kind]
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"compact deposit ({kind}): CUDA error {err}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("raster_variants: needs an NVIDIA GPU (torch.cuda.is_available()"
              " is False)", file=sys.stderr)
        return 1
    import numpy as np

    from particle_sim_tpu_torch.app import cli
    from particle_sim_tpu_torch.core import generate as gen
    from particle_sim_tpu_torch.core.params import SimParams
    from particle_sim_tpu_torch.core.state import ParticleState
    from particle_sim_tpu_torch.render import raster
    from particle_sim_tpu_torch.render import raster_compact as rc
    from particle_sim_tpu_torch.render import raster_sorted as rs
    from particle_sim_tpu_torch.render.camera import Camera

    sys.path.insert(0, str(ROOT))
    from chip_smoke import (
        bucket_of, bytes_ms, cargs_of, check_close, contended_keys,
        gpu_name_and_limit, median_ms, summation_bar,
    )

    dev = torch.device("cuda", 0)
    card = gpu_name_and_limit()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    libs = finish_builds(start_builds())

    def hollow(n):
        p, _, c = gen.generate(n)
        v = np.random.default_rng(0).normal(size=p.shape) * 3.0
        return ParticleState.from_arrays(p, v.astype(np.float32), c,
                                         device=dev)

    def frame_args(st, w, h):
        return (st.pos, st.vel, st.init_color,
                torch.from_numpy(SimParams(color_mode=1).pack()).to(dev),
                torch.from_numpy(Camera(aspect=w / h).view_proj()).to(dev),
                st.n_active)

    def cli_state():
        with tempfile.TemporaryDirectory() as tmp:
            final = os.path.join(tmp, "final.npz")
            with open(os.devnull, "w") as null:
                old, sys.stdout = sys.stdout, null
                try:
                    code = cli.main(["--count", "1000000", "--steps", "600",
                                     "--drag", "--orbit-mouse",
                                     "--checkpoint-every", "600",
                                     "--checkpoint", final])
                finally:
                    sys.stdout = old
            if code != 0:
                raise RuntimeError(f"cli.main returned {code}")
            with np.load(final) as z:
                return ParticleState.from_arrays(
                    z["positions"], z["velocities"], z["init_colors"],
                    device=dev)

    def frame_inputs(keys):
        """(SortedPoints, PairTable, n_tiles) of one frame's tile keys,
        through the package's own sort and compaction."""
        sp = rs.sort_points(keys)
        words = rc.words_of(keys)
        ck = rc.compact(*cargs_of(words), bucket=bucket_of(words, rc),
                        sentinel=words.sentinel)
        pt = rc.pair_table(*ck, n_tiles=words.n_tiles,
                           sentinel=words.sentinel)
        return sp, pt, keys.n_tiles

    s1, s16 = hollow(1_000_000), hollow(16_777_216)
    inputs = [
        ("1M @ 1280x720", raster.tile_keys(*frame_args(s1, 1280, 720),
                                           width=1280, height=720), False),
        ("16M @ 1920x1080", raster.tile_keys(*frame_args(s16, 1920, 1080),
                                             width=1920, height=1080),
         False),
        ("attractor CLI final state 1M @ 1280x720",
         raster.tile_keys(*frame_args(cli_state(), 1280, 720), width=1280,
                          height=720), False),
        ("contended: 1,048,576 points in one tile @ 1280x720",
         contended_keys(1 << 20, 900, 437, 5, dev), True)]
    del s16
    report = {"device": torch.cuda.get_device_name(0), "card": card,
              "configs": [name for name, _ in CONFIGS], "inputs": {}}
    for label, keys, contended in inputs:
        sp, pt, n_tiles = frame_inputs(keys)
        fb = n_tiles * 3 * 1024 * 4
        runs = {}
        for which, plain, call, words in (
                ("sorted", lambda: rs.deposit_plain(
                    sp.key, sp.rgb, sp.offsets, n_tiles=n_tiles),
                 lambda lib, kind: sorted_call(lib, kind, sp),
                 (sp.key, sp.rgb)),
                ("compact", lambda: rc.deposit_plain(
                    pt.table, pt.offsets, pt.key, pt.rg, pt.b,
                    n_tiles=n_tiles),
                 lambda lib, kind: compact_call(lib, kind, pt, n_tiles),
                 (pt.key, torch.stack(rc.unpack_rgb_bf16(pt.rg, pt.b))))):
            want = plain()
            if contended:
                exact, bar = summation_bar(*words, n_tiles)
            for name, c, kind in VARIANTS:
                got = call(libs[c], kind)
                if contended:
                    d = (got.double() - want.double()).abs()
                    if not (d <= 2 * bar).all():
                        raise AssertionError(
                            f"{label} {which} {name}: beyond 2 K u sum|x| "
                            f"(worst ratio {float((d / (2 * bar)).max())})")
                else:
                    check_close(f"{label} {which} {name}", got, want, 1e-4,
                                1e-5)
            fns = [lambda c=c, kind=kind: call(libs[c], kind)
                   for _, c, kind in VARIANTS]
            wrapper = (
                (lambda: rs.deposit(sp.key, sp.rgb, sp.offsets,
                                    n_tiles=n_tiles)) if which == "sorted"
                else (lambda: rc.deposit(pt.table, pt.offsets, pt.key, pt.rg,
                                         pt.b, n_tiles=n_tiles)))
            zero = torch.empty(fb // 4, dtype=torch.float32, device=dev)
            big = words[0].shape[0] > 2_000_000
            inner = 3 if big else 10
            ms = median_ms(fns + [wrapper, zero.zero_], reps=7, inner=inner,
                           lead_ms=inner * (2.0 if big else 0.3))
            # bytes bound: each point's words read once (sorted: key + 3
            # f32; compact: the bucket's key + 2 colour words, PAD chunk
            # included), the frame written once
            bound = bytes_ms(16 * sp.key.shape[0] + fb if which == "sorted"
                             else 12 * pt.key.shape[0] + fb)
            names = [v[0] for v in VARIANTS] + [
                f"the package's wrapper ({'rs' if which == 'sorted' else 'rc'}"
                ".deposit)", "memset of the frame alone (zero_)"]
            print(f"{label} {which}: bytes bound {bound:.5f} ms"
                  + (f", table {int(pt.offsets[-1])} entries in use"
                     if which == "compact" else ""))
            for name, t in zip(names, ms):
                print(f"  {name}: {t:.5f} ms ({bound / t:.1%} of the bound)")
            runs[which] = {"bound_ms": bound, "ms": dict(zip(names, ms))}
        report["inputs"][label] = runs
    (BUILD / "report.json").write_text(json.dumps(report, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
