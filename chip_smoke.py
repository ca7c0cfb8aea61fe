#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (particle_sim_tpu_torch) on one
NVIDIA GPU: builds the hand-written kernels, holds each against its plain
PyTorch version, drives the headless CLI at 1M particles (the attractor),
at 65,536 (direct-sum gravity) and at 1M (particle-mesh gravity), drives
the WebSocket server at 65,536, and times the kernels.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases (each prints a line; any failure raises and exits non-zero):
  1. build the CUDA kernels of particle_sim_tpu_torch/csrc/ with nvcc,
     and beside them (in parallel) the earlier designs of the two frame
     deposits, variant 0 of particle_sim_tpu_torch/tools/raster_variants.cu,
     and of the tensor-core force, variant 0 of
     particle_sim_tpu_torch/tools/pairwise_mxu_variants.cu
  2. step kernel vs plain PyTorch at 1M and 16,777,216 particles, three
     parameter sets, 1 and 5 substeps (rtol = atol = 1e-6 for one step,
     1e-5 for five)
  3. compaction kernel (bit-exact) and deposit kernel (|k - p| <= 1e-5 +
     1e-4 |p|: f32 sums in atomic order) vs their plain versions, at 1M
     particles @ 1280x720 and 16M @ 1920x1080, default camera; the whole
     frame through the kernels within one u8 level of the plain pipeline;
     the golden frame (tests/data/golden_raster_256x128.npz) through the
     kernels within 3 u8 levels; the deposit on a contended frame
     (1,048,576 points in one tile of 1280x720, ~1,024 a pixel): within
     K u sum|x| of a float64 sum and 2 K u sum|x| of plain at a pixel of K
     terms (u = 2^-24: both are f32 sums of the same terms)
  4. the main path: particle_sim_tpu_torch.app.cli.main at 1M particles,
     600 steps, orbiting dragged attractor, a 1280x720 frame every 100
     steps; checks the frames, the final state and the kernel launch counts
  5. times with CUDA events (medians after warm-up) of the step (1M,
     16M), compaction and deposit kernels (1M @ 1280x720, 16M @
     1920x1080; the deposit beside its earlier design, one block per
     tile, in the same turns) beside their plain versions, the one
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
     kernel within 3 u8 levels; the contended frame at phase 3's bars
  8. the gravity main path: particle_sim_tpu_torch.app.cli.main with
     --pairwise --central-mass 1000 at 65,536 particles, 200 steps, a
     sorted 1280x720 frame every 100 steps; checks the launch counts (the
     sort's too: each sorted frame sorts its tile keys with psort.sort, one
     histogram and one pass launch a digit), the frames, a finite final state, the masses, and that the total momentum
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
 10. times: pairwise at 65,536 and the sorted deposit at 1M and 16M (the
     latter beside its earlier design, one block per tile, in the same
     turns) beside their plain versions, library call and bound (for the
     pairwise sum
     the largest of its FP32 issue, flop and rsqrt bounds, beside the
     FP32 instructions a pair in the kernel's SASS); the sorted, compact
     and scatter frames (these include the host: the compact frame reads
     one count back per frame) and each frame's layers, among them the
     sorted frame's sort layer (rs.sort_points, through psort.sort's radix
     kernels) in turns with the torch.sort + gather it replaced
 11. particle-mesh deposit and gather kernels vs plain at 1M (hollow
     sphere, static box): G = 128 isolated with unit masses and with
     masses, G = 128 periodic with a fifth of the particles outside the
     box, G = 32, G = 96 (not a grid of the TPU kernels) and G = 256
     (deposit |k - p| <= 1e-5 max|p|: f32 sums in another order; gather
     <= 1e-6 max|p| on the solve's own layout, interleaved grids or dense
     planes, and on dense planes); pm_accel through the kernels vs the
     plain pm_accel_ref (<= 1e-4 max|a|; padding 0) in those five and
     auto_box with masses;
     the deposit and gather on phase 9's server state after its "pm"
     event (65,536, G = 128); PM (G = 128, eps 5) vs the pairwise kernel
     at 65,536 (filled sphere): rms relative error < 0.05
 12. the PM main path through the CLI at 1M: (a) the documented command
     --pm --pm-auto-box --pairwise-g 0.08 --dt 0.004 --diagnostics, 600
     steps; (b) --pm --central-mass 1000 --renderer sorted, 200 steps, a
     frame every 100; checks the launch counts (deposit = gather = step =
     steps, the mass deposit in (b); in (a) each diagnostics line adds a
     deposit and a gather, the mesh potential's; (b)'s two sorted frames
     launch the sort's kernels), a finite final state,
     momentum 0 and the centre of mass in place, the diagnostics lines,
     the frames; then deposit and gather vs plain on (b)'s final state
     (the cloud after its collapse, much of it clamped onto the box's
     faces): the deposit against a float64 sum of the same f32 corner
     weights, within K u |p| for a cell of K contributions (the f32
     summation bound), the gather within 1e-6 max|p|
 13. times: the PM deposit and gather kernels at 1M and 16,777,216 (G =
     128, static box) and on (b)'s final state, beside their plain
     versions, a library call (index_put_ of the 8N corner weights;
     grid_sample, trilinear, on dense planes) and the bytes bound; the PM
     step's layers (deposit, FFT solve, gather, momentum_clean, kick +
     step, the whole step) and torch.sort of N int32 cell keys (the sort
     the TPU design pays)
 14. the tensor-core all-pairs force (pairwise_cuda.pairwise_accel_mxu, no
     entry point calls it) at 65,536 (filled sphere, G = 2.5, eps 0.5):
     the square, 60,000 active with poisoned padding, 65,536 x 32,768 at
     j_base 32,768, 32,768 x 65,536 and 1,000 x 777 with 700 active,
     each once through the wrapper (the Hilbert key kernel, the radix sort
     of (key, index), the inlier box kernel, the force kernel: 5 launches
     of each kernel);
     against its plain version (within twice the plain version's own
     distance from the direct sum: both are the expanded f32 form) and
     against the pairwise kernel at the JAX bar, max |dA| / (|A| + 1e-2)
     < 0.05 per component, with the earlier design's error beside it; the
     Hilbert keys and the inlier box bit for bit the plain hilbert_keys
     and inlier_box (65,536, 1,000 and the poisoned padding; 8 and 10
     bits) and the radix order the plain stable hilbert_order; its SASS
     must hold HMMA; its registers, blocks an SM and the SASS mix a pair
     of its hot loop; times in turns with the earlier design (variant 0
     of tools/pairwise_mxu_variants.cu): the kernels alone, and the whole
     function against the earlier path (plain hilbert_order, a gather,
     variant 0, index_copy_); the receiver order against plain
     hilbert_order, the key and box kernels against their plain
     versions; the pairwise kernel, plain and the bound (the largest of
     rsqrt, the cube's FP32 and the products' TF32 flops)
 15. the sort (psort.sort: the radix kernels, histogram and passes) on the
     PM forward-sort words (cell key, idx, packed fractions[, mass]) at 1M
     and 16M (hollow sphere, G = 128), the un-sort words (2 x uint32 with
     keys up to 2^32 - 1 at 16M; idx + 3 f32), the raster tile keys of the
     1M @ 1280x720 frame with an index payload, tests/test_psort.py's
     distributions at 131,072, the ragged lengths 1,000,448, 80,000, 4,097
     and 1, and
     uint32 keys at and above 2^31 with key-max entries: every word equal
     to the plain version's and to a stable torch.sort's, one histogram
     and one pass launch a digit a case, the passes that ran (the device's
     tally) as radix_plan_ref predicts, no torch.sort route taken; the same
     cases through the earlier design (psort.merge_sort: block-sort and
     merge-round kernels) against its plain version, launch counts as the
     lengths predict; then times at 1M and 16M of the radix sort, its
     histogram and one pass, the merge sort and its kernels, torch.sort +
     index_select and the plain versions, beside the bytes bounds

The line before the last is a JSON object with one entry per kernel (the
launches of pm_deposit and pm_gather are phase 12's runs (a) and (b)
together; those of sorted_deposit, radix_hist and radix_pass phases 8
and 12 (b) together; those of pairwise_mxu, hilbert_keys, inlier_box,
block_sort and merge_round the drives of phases 14 and 15); the last line
is {"ok": true, "device": {...}}.
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
# the tensor-core force's least work a pair, whatever the design: one
# rsqrt, the cube's 2 FP32 multiplies, and the two products' flops counted
# once (r^2's -2 xi.xj: 3 multiply-adds; S = [x, y, z, 1] w: 4)
MXU_PAIR_FP32_INSTRS = 2
MXU_PAIR_TC_FLOPS = 14


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


#: SASS opcode classes of sass_mix (by the opcode's first word)
SASS_CLASSES = (
    ("HMMA", ("HMMA",)),
    ("MUFU", ("MUFU",)),
    ("FP32", ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK")),
    ("INT/LOP", ("IADD3", "IMAD", "LOP3", "SHF", "LEA", "ISETP", "IABS",
                 "SEL", "PRMT", "IMNMX", "POPC", "FLO", "BMSK", "SGXT",
                 "IADD", "LOP", "SHL", "SHR")),
    ("LDS", ("LDS", "LDSM")),
    ("STS", ("STS",)),
    ("CVT", ("F2F", "F2I", "I2F", "FRND", "F2FP", "I2FP")),
    ("MOV", ("MOV", "SHFL", "S2R", "CS2R", "S2UR")),
)


def sass_mix(lib_path, kernel: str, skip: str = "\0") -> dict:
    """The instruction mix of one kernel's machine code (cuobjdump -sass
    of the built library; the first function whose mangled name holds
    ``kernel`` and not ``skip``): counts by SASS_CLASSES ("other" for the
    rest, "uniform" for the U* datapath) over the whole function and over
    its hot loop, the innermost backward-branch loop that holds a
    MUFU.RSQ. -> {"whole": {...}, "loop": {...}, "loop_rsq": n}; a pair's
    mix is loop / loop_rsq (one rsqrt a pair and thread)."""
    from particle_sim_tpu_torch.utils import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return sass_mix_of(next(s for s in sass.split("Function : ")[1:]
                            if kernel in s.split()[0]
                            and skip not in s.split()[0]))


def sass_mix_of(body: str) -> dict:
    """sass_mix on the text of one function."""
    import re

    insts, labels, pending = [], {}, []
    for ln in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)"
                     r"\s*([^;]*);", ln)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        insts.append((addr, m.group(2), m.group(3)))

    def klass(op):
        base = op.split(".")[0]
        for name, ops in SASS_CLASSES:
            if base in ops:
                return name
        return "uniform" if base.startswith("U") else "other"

    def counts(rows):
        out = {name: 0 for name, _ in SASS_CLASSES}
        out.update(other=0, uniform=0)
        for _, op, _ in rows:
            out[klass(op)] += 1
        return out

    loops = []
    for addr, op, args in insts:
        if op.split(".")[0] != "BRA":
            continue
        m = re.search(r"\(\s*(\.L_x_\d+)\s*\)|0x([0-9a-f]+)", args)
        if not m:
            continue
        dest = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if dest is not None and dest <= addr:
            body_ = [r for r in insts if dest <= r[0] <= addr]
            rsq = sum(op_.startswith("MUFU.RSQ") for _, op_, _ in body_)
            if rsq:
                loops.append((addr - dest, body_, rsq))
    loop, rsq = (min(loops, key=lambda x: x[0])[1:] if loops else ([], 0))
    return {"whole": counts(insts), "loop": counts(loop), "loop_rsq": rsq}


def mix_per_pair(mix: dict) -> str:
    """A hot loop's mix a pair, as text: 'HMMA 0.50, MUFU 1.00, ...'."""
    n = max(mix["loop_rsq"], 1)
    return ", ".join(f"{k} {v / n:.2f}" for k, v in mix["loop"].items()
                     if v) + f" (hot loop: {sum(mix['loop'].values())} " \
        f"instructions, {mix['loop_rsq']} MUFU.RSQ)"


def torch_sort_points(keys):
    """The sorted renderer's sort as it was before it called psort.sort:
    torch.sort of the tile keys, then a gather of the stacked colours
    (phase 10's yardstick for rs.sort_points). -> (keys, f32[3, n])."""
    import torch

    key_s, order = torch.sort(keys.key)
    return key_s, torch.stack([keys.r, keys.g, keys.b])[:, order].contiguous()


def contended_keys(n, n_tiles, tile, seed, device):
    """TileKeys of a contended frame: n points in one tile, uniform over
    its 1,024 pixels (about n / 1,024 a pixel), colour in [0, 2^-10)."""
    import numpy as np
    import torch

    from particle_sim_tpu_torch.render.raster import TileKeys

    rng = np.random.default_rng(seed)
    key = (tile * 1024 + rng.integers(0, 1024, n)).astype(np.int32)
    rgb = torch.from_numpy(rng.random((3, n), dtype=np.float32) / 1024)
    return TileKeys(torch.from_numpy(key).to(device), *rgb.to(device),
                    n_tiles, n_tiles * 1024)


def summation_bar(key, vals, n_tiles):
    """The float64 sum of a deposit's f32 terms and its f32 summation
    bound: a pixel of K terms summed in f32 in any order lies within
    K u sum|x| of the exact sum (u = 2^-24). key: int32[n] frame keys
    (outside [0, n_tiles * 1024) draws nothing); vals: f32[3, n].
    -> (exact, bar), both f64[n_tiles, 3, 8, 128]."""
    import torch

    live = (key >= 0) & (key < n_tiles * 1024)
    k = torch.where(live, key, 0).long()
    w = live.double()
    count = torch.zeros(n_tiles * 1024, dtype=torch.float64,
                        device=key.device).index_add_(0, k, w)
    pix = (k >> 10) * 3072 + (k & 1023)
    exact = torch.zeros(n_tiles * 3072, dtype=torch.float64,
                        device=key.device)
    absum = torch.zeros_like(exact)
    for c in range(3):
        exact.index_add_(0, pix + c * 1024, vals[c].double() * w)
        absum.index_add_(0, pix + c * 1024, vals[c].double().abs() * w)
    shape = (n_tiles, 3, 8, 128)
    kk = count.view(n_tiles, 1, 8, 128)
    return exact.view(shape), kk * 2.0 ** -24 * absum.view(shape)


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
    from particle_sim_tpu_torch.tools import pairwise_mxu_variants as mxv
    from particle_sim_tpu_torch.tools import raster_variants
    from particle_sim_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_name_and_limit()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | python "
          f"{sys.version.split()[0]}")

    # -- phase 1: build ---------------------------------------------------------
    # the earlier designs of the two frame deposits (variant 0 of the
    # deposit probe), built beside the package's kernels: phases 5 and 10
    # time them in turns with the package's
    # and the earlier design of the tensor-core force (variant 0 of its
    # probe): phase 14 times it in turns with the package's
    rv_jobs = raster_variants.start_builds(raster_variants.CONFIGS[:1])
    mx_jobs = mxv.start_builds(mxv.CONFIGS[:1])
    path, secs = cuda_build.build()
    cuda_build.library()
    (rv_lib,) = raster_variants.finish_builds(rv_jobs, show_registers=False)
    ((mx_v0_lib, _),) = mxv.finish_builds(mx_jobs)
    log = path.with_suffix(".log")
    regs = [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or ln.startswith("==")] if log.exists() else []
    print(f"phase 1 build: {os.path.relpath(path, ROOT)} in {secs:.2f} s "
          f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for ln in regs:
        print(f"  ptxas: {ln}")

    err = {"step": 0.0, "compact": 0.0, "deposit": 0.0, "pairwise": 0.0,
           "sorted_deposit": 0.0, "pm_deposit": 0.0, "pm_gather": 0.0,
           "pairwise_mxu": 0.0, "hilbert_keys": 0.0, "inlier_box": 0.0,
           "sort": 0.0}
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

    def check_contended(which):
        """One deposit kernel ("deposit": the compact renderer's,
        "sorted_deposit") on the contended frame: 1,048,576 points in one
        tile of a 1280x720 frame, about 1,024 a pixel. Both the kernel and
        the plain version sum the same f32 terms in f32, each within
        K u sum|x| of the exact sum at a pixel of K terms: the kernel is
        held to a float64 sum within K u sum|x| and to the plain version
        within 2 K u sum|x|. -> worst ratio to the first bar."""
        keys = contended_keys(1 << 20, 900, 437, 5, dev)
        if which == "sorted_deposit":
            sp = rs.sort_points(keys)
            args, terms = (sp.key, sp.rgb, sp.offsets), (sp.key, sp.rgb)
            dk = rs.deposit(*args, n_tiles=900)
            dp = rs.deposit_plain(*args, n_tiles=900)
        else:
            words = rc.words_of(keys)
            ck = rc.compact(*cargs_of(words), bucket=bucket_of(words, rc),
                            sentinel=words.sentinel)
            pt = rc.pair_table(*ck, n_tiles=900, sentinel=words.sentinel)
            args = (pt.table, pt.offsets, pt.key, pt.rg, pt.b)
            terms = (pt.key, torch.stack(rc.unpack_rgb_bf16(pt.rg, pt.b)))
            dk = rc.deposit(*args, n_tiles=900)
            dp = rc.deposit_plain(*args, n_tiles=900)
        exact, bar = summation_bar(*terms, 900)
        d_plain = (dk.double() - dp.double()).abs()
        # worst ratios to the bars (an empty pixel's bar is 0: its error
        # must be 0 too)
        worst, worst_p = (float((d / b).nan_to_num(0.0, 1e30).max()) for d, b
                          in (((dk.double() - exact).abs(), bar),
                              (d_plain, 2 * bar)))
        if worst > 1.0 or worst_p > 1.0:
            fail(f"{which} on the contended frame: |k - float64| at "
                 f"{worst:.3g} of K u sum|x|, |k - p| at {worst_p:.3g} of "
                 f"2 K u sum|x|")
        err[which] = max(err[which], float(d_plain.max()))
        print(f"  {which} contended (1,048,576 points in one tile @ "
              f"1280x720): |k - float64| <= {worst:.3g} K u sum|x|, "
              f"|k - p| max {float(d_plain.max()):.3g}")
        return worst

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
    compact_inputs = {}
    for n, w, h in ((1_000_000, 1280, 720), (16_777_216, 1920, 1080)):
        compact_inputs[n] = (check_compact(
            f"n={n} {w}x{h}",
            frame_args(states[n], SimParams(color_mode=1),
                       Camera(aspect=w / h)), w, h), w, h)
    contended = {"deposit": check_contended("deposit")}
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
          f"{err['deposit']:.3g}, contended frame within "
          f"{contended['deposit']:.3g} K u sum|x|, golden frame max diff "
          f"{gdiff.max()} u8 "
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
    # the compaction and the compact deposit at both frame shapes; the
    # deposit beside its earlier design (one block per tile, variant 0 of
    # tools/raster_variants.cu) in the same turns
    cd_timing = {}
    for n, ((cargs, bucket, words, dargs), w, h) in compact_inputs.items():
        big = n > 2_000_000
        # the one PyTorch call for the compaction: index_select of the kept
        # chunks of the three word planes, stacked
        stacked = torch.stack(cargs[:3]).view(3, -1, rc.CHUNK)
        kept_idx = words.kept_list[: bucket // rc.CHUNK].long()
        inner = 5 if big else 20
        ck_ms, cp_ms, cl_ms = median_ms(
            [lambda: rc.compact(*cargs, bucket=bucket,
                                sentinel=words.sentinel),
             lambda: rc.compact_plain(*cargs, bucket=bucket,
                                      sentinel=words.sentinel),
             lambda: torch.index_select(stacked, 1, kept_idx)], inner=inner,
            lead_ms=inner * (2.0 if big else 0.3))
        # compaction bound: the kept words read, the bucket written
        c_bound = bytes_ms(12 * int(words.kept_n.item()) * rc.CHUNK
                           + 12 * bucket)
        # the one PyTorch call for the deposit: index_put_ with
        # accumulation of the points that each table entry's chunk adds to
        # the entry's tile, into the frame (the same sum before the clamp)
        table, offsets, key_p, rg_p, b_p = dargs
        keep = (table & rc._F_BIT) == 0
        s_idx = torch.clamp(table & rc._S_MASK,
                            max=key_p.shape[0] // rc.CHUNK - 1).long()[keep]
        ent_t = ((table >> rc._T_SHIFT) & rc._MAX_TILES)[keep]
        ekey = key_p.view(-1, rc.CHUNK)[s_idx]
        inside = (ekey >> 10) == ent_t[:, None]
        pix, live = frame_pixels(torch.where(inside, ekey, words.sentinel),
                                 words.n_tiles, w)
        r_, g_, b_ = rc.unpack_rgb_bf16(rg_p.view(-1, rc.CHUNK)[s_idx],
                                        b_p.view(-1, rc.CHUNK)[s_idx])
        lib_pix = pix[live]
        lib_rgb = torch.stack([r_, g_, b_], -1)[live]
        del ekey, inside, pix, live, r_, g_, b_
        fb_lib = torch.zeros((h * w, 3), dtype=torch.float32, device=dev)
        pt_ = rc.PairTable(*dargs)
        inner = 2 if big else 5
        dk_ms, d0_ms, dp_ms, dl_ms = median_ms(
            [lambda: rc.deposit(*dargs, n_tiles=words.n_tiles),
             lambda: raster_variants.compact_call(rv_lib, "v0", pt_,
                                                  words.n_tiles),
             lambda: rc.deposit_plain(*dargs, n_tiles=words.n_tiles),
             lambda: fb_lib.index_put_((lib_pix,), lib_rgb,
                                       accumulate=True)],
            inner=inner, lead_ms=inner * (6.0 if big else 0.5))
        # deposit bound: the point words read, the framebuffer written
        d_bound = bytes_ms(key_p.numel() * 12 + words.n_tiles * 3 * 1024 * 4)
        cd_timing[n] = {"compact": (ck_ms, cp_ms, cl_ms, c_bound),
                        "deposit": (dk_ms, dp_ms, dl_ms, d_bound)}
        print(f"phase 5 compact n={n} {w}x{h}: kernel {ck_ms:.5f} ms "
              f"({c_bound / ck_ms:.1%} of the bound) | plain {cp_ms:.5f} ms "
              f"| index_select {cl_ms:.5f} ms | bound {c_bound:.5f} ms")
        print(f"phase 5 deposit n={n} {w}x{h}: kernel {dk_ms:.5f} ms "
              f"({d_bound / dk_ms:.1%} of the bound) | earlier design (one "
              f"block a tile) {d0_ms:.5f} ms ({d0_ms / dk_ms:.2f}x) | plain "
              f"{dp_ms:.5f} ms | index_put_ {dl_ms:.5f} ms | bound "
              f"{d_bound:.5f} ms | table {int(offsets[-1])} entries in use")
        del lib_pix, lib_rgb, fb_lib

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
    contended["sorted_deposit"] = check_contended("sorted_deposit")
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
          f"{err['sorted_deposit']:.3g} (bar 1e-5 + 1e-4|p|; the contended "
          f"frame within {contended['sorted_deposit']:.3g} K u sum|x|), "
          f"frames within "
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
        psort.RADIX_HIST_LAUNCHES = psort.RADIX_PASS_LAUNCHES = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc_code = cli.main(argv)
        g_wall = time.perf_counter() - t0
        g_launches = {"pairwise": pairwise_cuda.LAUNCHES,
                      "sorted_deposit": rs.LAUNCHES,
                      "step": step_cuda.LAUNCHES,
                      "radix_hist": psort.RADIX_HIST_LAUNCHES,
                      "radix_pass": psort.RADIX_PASS_LAUNCHES}
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
    # each sorted frame sorts its tile keys: one histogram, one pass
    # launch a digit
    if g_launches != {"pairwise": g_steps, "sorted_deposit": 2,
                      "step": g_steps, "radix_hist": 2,
                      "radix_pass": 2 * psort.radix_digits()}:
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
        k_ms, k0_ms, p_ms, l_ms = median_ms(
            [lambda: rs.deposit(sp.key, sp.rgb, sp.offsets,
                                n_tiles=sp.n_tiles),
             lambda: raster_variants.sorted_call(rv_lib, "v0", sp),
             lambda: rs.deposit_plain(sp.key, sp.rgb, sp.offsets,
                                      n_tiles=sp.n_tiles),
             lambda: fb_lib.index_put_((lib_pix,), lib_rgb,
                                       accumulate=True)],
            inner=inner, lead_ms=inner * (0.5 if n == 1_000_000 else 8.0))
        bound = bytes_ms(16 * n + 12 * w * h)
        sd_timing[n] = (k_ms, p_ms, l_ms, bound)
        print(f"phase 10 sorted deposit n={n} {w}x{h}: kernel {k_ms:.5f} ms "
              f"({bound / k_ms:.1%} of the bound) | earlier design (one "
              f"block a tile) {k0_ms:.5f} ms ({k0_ms / k_ms:.2f}x) | plain "
              f"{p_ms:.5f} ms | index_put_ {l_ms:.5f} ms | bound "
              f"{bound:.5f} ms")
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
        if not torch.equal(sp.key, torch_sort_points(keys)[0]):
            fail(f"sort_points {label}: keys differ from torch.sort's")
        words = rc.point_words(*args, width=w, height=h)
        bucket = bucket_of(words, rc)
        ck = rc.compact(*cargs_of(words), bucket=bucket,
                        sentinel=words.sentinel)
        pt = rc.pair_table(*ck, n_tiles=words.n_tiles,
                           sentinel=words.sentinel)
        layers = median_ms(
            [lambda: raster.tile_keys(*args, width=w, height=h),
             lambda: rs.sort_points(keys),
             lambda: torch_sort_points(keys),
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
                      ("sorted: tile_keys", "sort_points (psort.sort: "
                       "radix kernels)", "sort_points as torch.sort + "
                       "gather (yardstick)", "deposit",
                       "compact: point_words", "kept_n host read", "compact",
                       "pair_table", "deposit"), layers)))
        print(f"phase 10 sort layer {label} {w}x{h}: sort_points through "
              f"psort.sort((key, r, g, b)) {layers[1]:.5f} ms | torch.sort + "
              f"gather {layers[2]:.5f} ms ({layers[2] / layers[1]:.2f}x)")

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
        # the solve's own layout (the interleaved view, or dense planes for
        # periodic 'exact'), then the same values as dense planes: both of
        # the gather kernel's paths
        grids = pm.solve_accel(dp, cfg, cfg.softening)
        layout = pm_cuda.grid_layout(grids, pos)
        gp = pm_cuda.gather_plain(grids, pos, n_act, box, cell,
                                  periodic=periodic)
        torch.cuda.synchronize()
        scale = float(gp.abs().max())
        e = 0.0
        for gr in (grids, grids.contiguous()):
            gk = pm_cuda.gather(gr, pos, n_act, box, cell, periodic=periodic)
            torch.cuda.synchronize()
            e = max(e, check_close(
                f"pm gather {label} ({pm_cuda.grid_layout(gr, pos)})", gk,
                gp, 0.0, 1e-6 * scale))
        err["pm_gather"] = max(err["pm_gather"], e)
        notes.append(f"gather ({layout} and planar) {e:.3g} = "
                     f"{e / scale:.3g} of max|p| {scale:.6g}")
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
            psort.RADIX_HIST_LAUNCHES = psort.RADIX_PASS_LAUNCHES = 0
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc_code = cli.main(argv)
            wall = time.perf_counter() - t0
            got = {"pm_deposit": pm_cuda.DEPOSIT_LAUNCHES,
                   "pm_deposit_mass": pm_cuda.DEPOSIT_MASS_LAUNCHES,
                   "pm_gather": pm_cuda.GATHER_LAUNCHES,
                   "step": step_cuda.LAUNCHES,
                   "sorted_deposit": rs.LAUNCHES,
                   "radix_hist": psort.RADIX_HIST_LAUNCHES,
                   "radix_pass": psort.RADIX_PASS_LAUNCHES}
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
                "sorted_deposit": 0 if tag == "a" else 2,
                "radix_hist": 0 if tag == "a" else 2,
                "radix_pass": 0 if tag == "a" else 2 * psort.radix_digits()}
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
        # the yardstick reads dense planes, as grid_sample takes them
        lib_grids = grids.contiguous()[None]
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
    mx_cases = mxv.phase14_cases(x)
    # the drive: every case once through the kernel's wrapper (the Hilbert
    # key kernel, the radix sort of (key, index), the inlier box kernel,
    # the force kernel)
    pairwise_cuda.MXU_LAUNCHES = pairwise_cuda.HILBERT_LAUNCHES = 0
    pairwise_cuda.BOX_LAUNCHES = 0
    mx_got = [pairwise_cuda.pairwise_accel_mxu(xi_, xj_, na, mx_g, mx_eps,
                                               j_base=jb)
              for _, xi_, xj_, na, jb in mx_cases]
    torch.cuda.synchronize()
    mx_launches = pairwise_cuda.MXU_LAUNCHES
    hk_launches = pairwise_cuda.HILBERT_LAUNCHES
    ib_launches = pairwise_cuda.BOX_LAUNCHES
    if not mx_launches == hk_launches == ib_launches == len(mx_cases):
        fail(f"pairwise_mxu: {mx_launches} force, {hk_launches} key and "
             f"{ib_launches} box launches for {len(mx_cases)} calls")
    mx_rel = mx_rel_v0 = 0.0
    for (label, xi_, xj_, na, jb), got in zip(mx_cases, mx_got):
        want = pairwise.pairwise_accel_mxu_ref(xi_, xj_, na, mx_g, mx_eps,
                                               j_base=jb)
        direct = pairwise_cuda.pairwise_accel(xi_.T, xj_, na, mx_g, mx_eps,
                                              j_base=jb).T
        # the earlier design behind the plain Hilbert order, for comparison
        v0 = mxv.earlier_path(mx_v0_lib, xi_, xj_, na, mx_g, mx_eps, jb)
        torch.cuda.synchronize()
        # both are the expanded f32 form: the bar is twice the plain
        # version's own distance from the direct sum (the pairwise kernel)
        plain_err = float((want - direct).abs().max())
        e = check_close(f"pairwise_mxu {label}", got, want, 0.0,
                        2.0 * plain_err)
        err["pairwise_mxu"] = max(err["pairwise_mxu"], e)
        rel, rel_v0, rel_plain = (
            float(((a - direct).abs() / (direct.abs() + 1e-2)).max())
            for a in (got, v0, want))
        rel_norm = float(((got - direct).norm(dim=0)
                          / (direct.norm(dim=0) + 1e-2)).max())
        if not rel < 0.05:
            fail(f"pairwise_mxu {label}: max |dA| / (|A| + 1e-2) {rel:.4g} "
                 f"against the pairwise kernel (bar 0.05)")
        mx_rel, mx_rel_v0 = max(mx_rel, rel), max(mx_rel_v0, rel_v0)
        print(f"  pairwise_mxu {label}: max |k - p| {e:.3g} (bar "
              f"{2.0 * plain_err:.3g}, max|p| {float(want.abs().max()):.4g});"
              f" against the pairwise kernel max |dA| / (|A| + 1e-2) "
              f"{rel:.4g} a component (earlier design {rel_v0:.4g}, plain "
              f"{rel_plain:.4g}), {rel_norm:.3g} a particle")
    # the Hilbert key kernel: bit for bit the plain keys; the order it
    # gives through the radix sort: the plain stable argsort's
    hk_cases = [("65536", x), ("1000", x[:, :1000].contiguous()),
                ("poisoned padding", poisoned)]
    for label, pts in hk_cases:
        for bits in (8, 10):
            hk = pairwise_cuda.hilbert_keys_kernel(pts, bits)
            hp = pairwise_cuda.hilbert_keys(pts, bits)
            err["hilbert_keys"] = max(err["hilbert_keys"], float(
                (hk.long() - hp.long()).abs().max()))
            if not torch.equal(hk, hp):
                fail(f"hilbert_keys {label} bits {bits}: "
                     f"{int((hk != hp).sum())} keys differ from plain")
        if not torch.equal(pairwise_cuda.receiver_order(pts).long(),
                           pairwise_cuda.hilbert_order(pts)):
            fail(f"receiver_order {label}: differs from hilbert_order")
        ibk = pairwise_cuda.inlier_box_kernel(pts)
        ibp = pairwise_cuda.inlier_box(pts)
        err["inlier_box"] = max(err["inlier_box"], float(torch.where(
            ibk == ibp, 0.0, (ibk - ibp).abs()).max()))
        if not torch.equal(ibk, ibp):
            fail(f"inlier_box {label}: kernel {ibk.tolist()} against plain "
                 f"{ibp.tolist()}")
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
    mx_mix = sass_mix(path, "pairwise_mxu_kernel")
    mx_occ = mxv.occupancy(cuda_build.library())
    # times at 65,536^2, in turns: the kernels alone (the new one reads
    # its receivers through the order, the earlier takes them gathered),
    # then the whole function against the earlier path
    mx_in = mxv.Inputs(x, x, N_GRAVITY)
    lib_pkg = cuda_build.library()
    mxk = median_ms(
        [lambda: mxv.v0_call(mx_v0_lib, mx_in),
         lambda: mxv.kernel_call(lib_pkg, mx_in),
         lambda: mxv.kernel_call(lib_pkg, mx_in),
         lambda: mxv.v0_call(mx_v0_lib, mx_in)],
        reps=7, inner=5, lead_ms=5 * 5.0)
    mxw = median_ms(
        [lambda: mxv.earlier_path(mx_v0_lib, x, x, N_GRAVITY, mx_g, mx_eps),
         lambda: pairwise_cuda.pairwise_accel_mxu(x, x, N_GRAVITY, mx_g,
                                                  mx_eps),
         lambda: pairwise_cuda.pairwise_accel_mxu(x, x, N_GRAVITY, mx_g,
                                                  mx_eps),
         lambda: mxv.earlier_path(mx_v0_lib, x, x, N_GRAVITY, mx_g, mx_eps),
         lambda: pairwise_cuda.pairwise_accel(x.T, x, N_GRAVITY, mx_g,
                                              mx_eps)],
        reps=7, inner=5, lead_ms=5 * 8.0)
    mx_ms, mxv0_ms = (mxk[1] + mxk[2]) / 2, (mxk[0] + mxk[3]) / 2
    mxf_ms, mxfv0_ms = (mxw[1] + mxw[2]) / 2, (mxw[0] + mxw[3]) / 2
    mxd_ms = mxw[4]
    # the receiver order: key kernel + radix sort against the plain
    # Hilbert order; the key kernel alone (box given) against plain keys;
    # the inlier box
    hk_box = pairwise_cuda.hilbert_box(x)
    mxo = median_ms(
        [lambda: pairwise_cuda.hilbert_order(x),
         lambda: pairwise_cuda.receiver_order(x),
         lambda: pairwise_cuda.receiver_order(x),
         lambda: pairwise_cuda.hilbert_order(x),
         lambda: pairwise_cuda.hilbert_keys_kernel(x, 8, hk_box),
         lambda: pairwise_cuda.hilbert_keys(x, 8, hk_box),
         lambda: pairwise_cuda.inlier_box_kernel(x),
         lambda: pairwise_cuda.inlier_box(x)],
        reps=7, inner=10, lead_ms=10 * 0.3)
    mxo_plain, mxo_new = (mxo[0] + mxo[3]) / 2, (mxo[1] + mxo[2]) / 2
    hk_ms, hkp_ms, ib_ms, ibp_ms = mxo[4:8]
    hk_bound = bytes_ms(16 * N_GRAVITY)
    # the box reads its strided sample once (3 x 4,096 f32), writes 6 f32
    ib_bound = bytes_ms(12 * (-(-N_GRAVITY // max(1, N_GRAVITY // 4096)))
                        + 24)
    (mxp_ms,) = median_ms(
        [lambda: pairwise.pairwise_accel_mxu_ref(x, x, N_GRAVITY, mx_g,
                                                 mx_eps)], reps=3, inner=1)
    # the bound, whatever the design: one rsqrt a pair (MUFU, 16/SM/clock),
    # the cube's 2 FP32 instructions a pair, and the products' flops once
    # (r^2's -2 xi.xj, 3 multiply-adds; S, 4) at the TF32 rate
    mx_rsqrt = pairs / RSQRT_PER_S * 1e3
    mx_cube = MXU_PAIR_FP32_INSTRS * pairs / FP32_INSTRS_PER_S * 1e3
    mx_tc = MXU_PAIR_TC_FLOPS * pairs / TF32_FLOPS_PER_S * 1e3
    mx_bound = max(mx_rsqrt, mx_cube, mx_tc)
    print(f"phase 14 pairwise_mxu at {N_GRAVITY}: {len(mx_cases)} cases, "
          f"max |k - p| {err['pairwise_mxu']:.3g}, against the pairwise "
          f"kernel max {mx_rel:.4g} a component (bar 0.05; the earlier "
          f"design {mx_rel_v0:.4g}); hilbert keys and inlier box == plain "
          f"(bit-exact) and the radix order == hilbert_order at 65536, "
          f"1000 and poisoned padding; launches: force {mx_launches}, keys "
          f"{hk_launches}, box {ib_launches} ({time.perf_counter() - t0:.1f}"
          f" s)")
    print(f"phase 14 pairwise_mxu kernel: {mx_occ['registers']} registers, "
          f"{mx_occ['local_bytes']} B local, {mx_occ['shared_bytes']} B "
          f"shared, {mx_occ['blocks_per_sm']} blocks of "
          f"{mx_occ['threads']} threads an SM ({mx_occ['receivers_per_block']}"
          f" receivers a block); SASS {mx_sass['hmma']} HMMA, "
          f"{mx_sass['rsq']} MUFU.RSQ, {mx_sass['fp32']} FP32; a pair in "
          f"its hot loop: {mix_per_pair(mx_mix)}")
    print(f"phase 14 pairwise_mxu {N_GRAVITY}^2: kernel {mx_ms:.4f} ms "
          f"({pairs / mx_ms * 1e3:.4g} pairs/s, {mx_bound / mx_ms:.1%} of the "
          f"bound) against the earlier design {mxv0_ms:.4f} ms (in turns: "
          f"{' | '.join(f'{t:.4f}' for t in mxk)}) | whole function "
          f"{mxf_ms:.4f} ms against the earlier path {mxfv0_ms:.4f} ms (in "
          f"turns: {' | '.join(f'{t:.4f}' for t in mxw[:4])}) | pairwise "
          f"kernel {mxd_ms:.4f} ms | plain {mxp_ms:.3f} ms | bound "
          f"{mx_bound:.4f} ms (largest of: rsqrt at 16/SM/clock "
          f"{mx_rsqrt:.4f} ms; the cube's {MXU_PAIR_FP32_INSTRS} FP32 "
          f"instructions/pair at 128/SM/clock {mx_cube:.4f} ms; "
          f"{MXU_PAIR_TC_FLOPS} flops/pair of the two products at 495 TFLOP/s"
          f" TF32 {mx_tc:.4f} ms) | library: none")
    print(f"phase 14 receiver order {N_GRAVITY}: key kernel + radix sort "
          f"{mxo_new:.4f} ms against plain hilbert_order {mxo_plain:.4f} ms "
          f"(in turns: {' | '.join(f'{t:.4f}' for t in mxo[:4])}); key "
          f"kernel alone {hk_ms:.5f} ms (plain {hkp_ms:.4f} ms, bytes bound "
          f"{hk_bound:.5f} ms); inlier box kernel {ib_ms:.5f} ms (plain "
          f"inlier_box {ibp_ms:.4f} ms, bytes bound {ib_bound:.6f} ms); of "
          f"the whole function {mxf_ms:.4f} ms the force kernel is "
          f"{mx_ms / mxf_ms:.1%}")

    # -- phase 15: the sort: radix kernels, and the merge sort's ---------------
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
    for n in (1_000_448, 80_000, 4097, 1):
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

    # the drive: every case once through psort.sort (the radix kernels)
    n_digits = psort.radix_digits()
    psort.RADIX_HIST_LAUNCHES = psort.RADIX_PASS_LAUNCHES = 0
    psort.BLOCK_LAUNCHES = psort.MERGE_LAUNCHES = psort.LIBRARY_CALLS = 0
    taken0 = psort.radix_passes_taken(dev)
    sorted_out = [psort.sort(ops) for _, ops in sort_cases]
    torch.cuda.synchronize()
    plans = [psort.radix_plan_ref(ops[0]) for _, ops in sort_cases]
    sort_launches = {"radix_hist": psort.RADIX_HIST_LAUNCHES,
                     "radix_pass": psort.RADIX_PASS_LAUNCHES,
                     "passes_taken": psort.radix_passes_taken(dev) - taken0,
                     "block_sort": psort.BLOCK_LAUNCHES,
                     "merge_round": psort.MERGE_LAUNCHES}
    # one histogram a sort, one pass launch a digit; the passes that ran
    # (the device's tally) are the digits radix_plan_ref finds not constant
    want_launches = {"radix_hist": len(sort_cases),
                     "radix_pass": n_digits * len(sort_cases),
                     "passes_taken": sum(len(p) for p in plans),
                     "block_sort": 0, "merge_round": 0}
    if sort_launches != want_launches or psort.LIBRARY_CALLS:
        fail(f"sort: launches {sort_launches}, expected {want_launches}; "
             f"torch.sort route taken {psort.LIBRARY_CALLS} times")

    def check_words(label, got, plain, ops, design):
        order = torch.sort(psort.ordered_key(ops[0]), stable=True).indices
        for w, (o, g_, p_) in enumerate(zip(ops, got, plain)):
            gi = g_.view(torch.int32)
            if not torch.equal(gi, p_.view(torch.int32)):
                fail(f"{design} {label}: word {w} differs from plain")
            if not torch.equal(gi, o.view(torch.int32)[order]):
                fail(f"{design} {label}: word {w} differs from a stable "
                     f"torch.sort")

    for (label, ops), got, plan in zip(sort_cases, sorted_out, plans):
        check_words(label, got, psort.radix_sort_ref(ops), ops, "sort")
        # the first and last key (an int32 key's order value is key + 2^31)
        k = psort.ordered_key(got[0])[[0, -1]] - (
            1 << 31 if got[0].dtype == torch.int32 else 0)
        print(f"  sort {label}: n {ops[0].shape[0]}, {len(ops)} words, "
              f"{ops[0].dtype}, keys {int(k[0])}..{int(k[1])}, "
              f"{len(plan)} radix passes (shifts {list(plan)}): == plain, "
              f"== stable torch.sort")
    # the earlier design, the merge sort's kernels, on the same cases
    psort.BLOCK_LAUNCHES = psort.MERGE_LAUNCHES = 0
    merged = [psort.merge_sort(ops) for _, ops in sort_cases]
    torch.cuda.synchronize()
    merge_launches = {"block_sort": psort.BLOCK_LAUNCHES,
                      "merge_round": psort.MERGE_LAUNCHES}
    want_merge = {"block_sort": len(sort_cases), "merge_round": sum(
        rounds(ops[0].shape[0]) for _, ops in sort_cases)}
    if merge_launches != want_merge:
        fail(f"merge sort: launches {merge_launches}, expected {want_merge}")
    for (label, ops), got in zip(sort_cases, merged):
        check_words(label, got, psort.merge_sort_ref(ops), ops, "merge sort")
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
        halves = [psort.merge_sort([o[:last_run] for o in ops]),
                  psort.merge_sort([o[last_run:] for o in ops])]
        last_in = [torch.cat([a, b]) for a, b in zip(*halves)]
        outs = [torch.empty_like(o) for o in ops]
        scratch = [torch.empty_like(o) for o in ops]

        def hist_and_pass0():
            ws = psort.radix_histogram(ops[0])
            psort.radix_pass(ops, outs, scratch, ws, 0)

        inner = 3 if big_ else 10
        (r_ms, h_ms, hp_ms, s_ms, sl_ms, b_ms, m1_ms, ml_ms, bl_ms,
         ml_lib_ms) = median_ms(
            [lambda: psort.sort(ops),
             lambda: psort.radix_histogram(ops[0]),
             hist_and_pass0,
             lambda: psort.merge_sort(ops),
             lambda: lib_sort(ops),
             lambda: psort.block_sort(ops),
             lambda: psort.merge_round(blk, psort.SEG),
             lambda: psort.merge_round(last_in, last_run),
             lambda: lib_sort(ops, psort.SEG),
             lambda: lib_sort(last_in)],
            reps=5, inner=inner, lead_ms=inner * (6.0 if big_ else 0.5))
        rp_ms, hp_plain_ms, pp_ms, sp_ms, bp_ms, mlp_ms = median_ms(
            [lambda: psort.radix_sort_ref(ops),
             lambda: psort.radix_plan_ref(ops[0]),
             lambda: psort.radix_pass_ref(ops, 0),
             lambda: psort.merge_sort_ref(ops),
             lambda: psort.block_sort_ref(ops),
             lambda: psort.merge_round_ref(last_in, last_run)],
            reps=3, inner=1)
        passes = len(psort.radix_plan_ref(ops[0]))
        pass_ms = hp_ms - h_ms
        # bytes: the histogram reads the keys and writes the counts; a pass
        # reads and writes every word; a merge-sort launch the same
        hist_bound = bytes_ms(4 * n + 4 * n_digits * 256)
        pass_bound = bytes_ms(8 * words * n)
        radix_bound = hist_bound + passes * pass_bound
        r = rounds(n)
        sort_timing[label] = dict(
            radix=r_ms, hist=h_ms, hist_plain=hp_plain_ms,
            hist_bound=hist_bound, pass_=pass_ms, pass_plain=pp_ms,
            pass_bound=pass_bound, block=b_ms, block_plain=bp_ms,
            block_lib=bl_ms, merge=ml_ms, merge_plain=mlp_ms,
            merge_lib=ml_lib_ms, bound=pass_bound)
        print(f"phase 15 sort {label} PM forward-sort words ({words} x "
              f"int32, n {n}): radix sort ({passes} passes) {r_ms:.4f} ms "
              f"(plain {rp_ms:.3f}) | its histogram {h_ms:.4f} ms (plain "
              f"radix_plan_ref {hp_plain_ms:.3f}; bound {hist_bound:.4f}) "
              f"| one pass (histogram + pass 0, less the histogram) "
              f"{pass_ms:.4f} ms (plain {pp_ms:.3f}; bound {pass_bound:.4f})"
              f" | merge sort ({1 + r} launches) {s_ms:.4f} ms (plain "
              f"{sp_ms:.3f}) | torch.sort(key) + index_select {sl_ms:.4f} "
              f"ms | bytes bound of the radix sort {radix_bound:.4f} ms "
              f"({radix_bound / r_ms:.1%}), of the merge sort "
              f"{(1 + r) * pass_bound:.4f} ms")
        print(f"phase 15 merge sort {label}: block sort {b_ms:.4f} ms (plain "
              f"{bp_ms:.3f}, torch.sort of the full {psort.SEG}-rows + "
              f"gather {bl_ms:.4f}) | merge round L={psort.SEG} "
              f"{m1_ms:.4f} ms, L={last_run} {ml_ms:.4f} ms (plain "
              f"{mlp_ms:.3f}, torch.sort + gather {ml_lib_ms:.4f}) | bound "
              f"a launch {pass_bound:.4f} ms (bytes)")
    print(f"phase 15 sort: {len(sort_cases)} cases == plain and == stable "
          f"torch.sort through the radix kernels and through the merge "
          f"sort's, launches {sort_launches} and {merge_launches}, "
          f"torch.sort route only outside the contract "
          f"({time.perf_counter() - t0:.1f} s)")

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
         "ms": cd_timing[1_000_000]["compact"][0],
         "plain_ms": cd_timing[1_000_000]["compact"][1],
         "bound_ms": cd_timing[1_000_000]["compact"][3],
         "bound_by": "bytes",
         "library_ms": cd_timing[1_000_000]["compact"][2]},
        {"name": "deposit", "route": "cuda",
         "source": src + "raster_compact.cu",
         "replaces": "particle_sim_tpu/render/raster_compact.py:85",
         "launches": launches["deposit"], "max_abs_err": err["deposit"],
         "ms": cd_timing[1_000_000]["deposit"][0],
         "plain_ms": cd_timing[1_000_000]["deposit"][1],
         "bound_ms": cd_timing[1_000_000]["deposit"][3],
         "bound_by": "bytes",
         "library_ms": cd_timing[1_000_000]["deposit"][2]},
        {"name": "pairwise", "route": "cuda", "source": src + "pairwise.cu",
         "replaces": "particle_sim_tpu/ops/pairwise_pallas.py:54",
         "launches": g_launches["pairwise"], "max_abs_err": err["pairwise"],
         "ms": pw_ms, "plain_ms": pwp_ms, "bound_ms": pw_bound,
         "bound_by": "operations", "library_ms": None},
        {"name": "sorted_deposit", "route": "cuda",
         "source": src + "raster_sorted.cu",
         "replaces": "particle_sim_tpu/render/raster_sorted.py:47",
         "launches": g_launches["sorted_deposit"]
         + pm_runs["b"][0]["sorted_deposit"],
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
        # the kernel alone (receivers read through the order); the whole
        # function is phase 14's line
        {"name": "pairwise_mxu", "route": "cuda",
         "source": src + "pairwise_mxu.cu",
         "replaces": "particle_sim_tpu/ops/pairwise_pallas.py:179",
         "launches": mx_launches, "max_abs_err": err["pairwise_mxu"],
         "ms": mx_ms, "plain_ms": mxp_ms, "bound_ms": mx_bound,
         "bound_by": "operations", "library_ms": None},
        # the receiver order of the same function (row 8): Hilbert keys,
        # bit-exact with the plain hilbert_keys; at 65,536, box given
        {"name": "hilbert_keys", "route": "cuda",
         "source": src + "hilbert.cu",
         "replaces": "particle_sim_tpu/ops/pairwise_pallas.py:179",
         "launches": hk_launches, "max_abs_err": err["hilbert_keys"],
         "ms": hk_ms, "plain_ms": hkp_ms, "bound_ms": hk_bound,
         "bound_by": "bytes", "library_ms": None},
        # the block centres' inlier box of the same function (row 8),
        # bit-exact with the plain inlier_box; at 65,536
        {"name": "inlier_box", "route": "cuda",
         "source": src + "hilbert.cu",
         "replaces": "particle_sim_tpu/ops/pairwise_pallas.py:179",
         "launches": ib_launches, "max_abs_err": err["inlier_box"],
         "ms": ib_ms, "plain_ms": ibp_ms, "bound_ms": ib_bound,
         "bound_by": "bytes", "library_ms": None},
        # the earlier design of the sort (phase 15's merge-sort drive),
        # both at the 16M PM forward-sort words; merge_round: the last
        # round (two runs of 8M)
        {"name": "block_sort", "route": "cuda", "source": src + "psort.cu",
         "replaces": "particle_sim_tpu/ops/psort.py:232",
         "launches": merge_launches["block_sort"],
         "max_abs_err": err["sort"], "ms": sort_timing["16M"]["block"],
         "plain_ms": sort_timing["16M"]["block_plain"],
         "bound_ms": sort_timing["16M"]["bound"], "bound_by": "bytes",
         "library_ms": sort_timing["16M"]["block_lib"]},
        {"name": "merge_round", "route": "cuda", "source": src + "psort.cu",
         "replaces": "particle_sim_tpu/ops/psort.py:289",
         "launches": merge_launches["merge_round"],
         "max_abs_err": err["sort"], "ms": sort_timing["16M"]["merge"],
         "plain_ms": sort_timing["16M"]["merge_plain"],
         "bound_ms": sort_timing["16M"]["bound"], "bound_by": "bytes",
         "library_ms": sort_timing["16M"]["merge_lib"]},
        # psort.sort's route since the redesign: the two radix kernels
        # together replace both TPU kernels (the block sort and the merge
        # rounds that psort.sort chains); launches: the sorted frames of
        # phases 8 and 12 (b); times at the 16M PM forward-sort words, one
        # pass taken (digit 0); plain: radix_plan_ref / radix_pass_ref; no
        # single PyTorch call computes either function
        {"name": "radix_hist", "route": "cuda",
         "source": src + "radix_sort.cu",
         "replaces": "particle_sim_tpu/ops/psort.py:232",
         "launches": g_launches["radix_hist"]
         + pm_runs["b"][0]["radix_hist"],
         "max_abs_err": err["sort"], "ms": sort_timing["16M"]["hist"],
         "plain_ms": sort_timing["16M"]["hist_plain"],
         "bound_ms": sort_timing["16M"]["hist_bound"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "radix_pass", "route": "cuda",
         "source": src + "radix_sort.cu",
         "replaces": "particle_sim_tpu/ops/psort.py:289",
         "launches": g_launches["radix_pass"]
         + pm_runs["b"][0]["radix_pass"],
         "max_abs_err": err["sort"], "ms": sort_timing["16M"]["pass_"],
         "plain_ms": sort_timing["16M"]["pass_plain"],
         "bound_ms": sort_timing["16M"]["pass_bound"], "bound_by": "bytes",
         "library_ms": None},
    ]
    print(gpu_name_and_limit())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
