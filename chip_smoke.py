#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (particle_sim_tpu_torch) on one
NVIDIA GPU: builds the hand-written kernels, holds each against its plain
PyTorch version, drives the headless CLI at 1M particles (the attractor),
at 65,536 (direct-sum gravity) and at 1M (particle-mesh gravity, and the
multi-level mesh with the window-exact correction), drives the WebSocket
server at 65,536, the mesh path at world size 1, the packaging tool and
the five worked examples, and times the kernels.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases (each prints a line; any failure raises and exits non-zero):
  1. build the CUDA kernels of particle_sim_tpu_torch/csrc/ with nvcc,
     and beside them (in parallel) the earlier designs of the two frame
     deposits, variant 0 of particle_sim_tpu_torch/tools/raster_variants.cu,
     of the tensor-core force, variant 0 of
     particle_sim_tpu_torch/tools/pairwise_mxu_variants.cu, and of the
     direct force, variant 0 of
     particle_sim_tpu_torch/tools/pairwise_variants.cu
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
     at the same bar: the difference pass (pmx's correction, eps 0.5 and
     2.0) on the square and with the central mass; the live counts (n_i
     50,000, n_j 40,000 on the device, NaN in the receivers, sources and
     masses past them: the rows past n_i exactly 0), single and
     difference; the ragged shapes 40,001 x 30,011 (both) and 1,000 x 777
     with counts 999 / 700; two launches bit for bit (the square, the
     difference with counts); one direct-sum step (kernel, plain kick,
     step kernel) vs the plain step
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
     "pm" solver event, then a "pm" event with a refinement level
     (pm2_sizes [32]) and an exact window (pmx_size 8); checks the headers,
     reflected_seq, the status ("solver": "pm", the stack and the window)
     and the launch counts (the PM kernels' included, and the pairwise
     and radix kernels after the pm2/pmx event);
     then the compaction and deposit kernels vs plain (phase 3's bars) on
     the server's state, parameters and camera at its shape, 65,536 @
     1280x720 (its PM deposit and gather follow in phase 11)
 10. times: pairwise at 65,536 (beside its earlier design, variant 0 of
     tools/pairwise_variants.cu, in turns) and the sorted deposit at 1M
     and 16M (beside its earlier design, one block per tile, in the same
     turns) beside their plain versions, library call and bound (for the
     pairwise sum the flops at the FP32 peak, beside the FP32 issue and
     rsqrt bounds, the kernel's registers, blocks an SM, receivers a
     thread, source slices and its hot loop's SASS mix a pair, the
     difference pass's and variant 0's, and the SM clock and power while
     it runs back to back); the sorted, compact
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
     frame every 100; checks the launch counts (deposit = gather = kicked
     gather = steps and no step kernel: the single-level tail from the
     grids, phase 25; the mass deposit in (b); in (a) each diagnostics
     line adds a
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
 16. pm2 / pmn (ops/pm2.py) at 1M: bench.py's two-level scene (half a
     N(2) clump at (5, 4, -3), half a N(20) halo, clipped to +-60; G =
     128, static box, coarse eps 3), tracked windows 32 / 0.75 and 8 /
     0.25: the kernel path (pmn_accel) against the plain path
     (pmn_accel_ref) within 1e-4 max|a| (phase 11's pm_accel bar), one
     and two levels; NaN in dead slots under a static stack changes
     nothing; tests/test_pm2.py's scene through the kernels (rms < 0.03
     against the direct sum at eps 0.75 inside the window, < coarse / 10)
     and tests/test_pmn.py's (core rms < 0.06 with two levels, each level
     cutting it); the engine (Method.CUDA, two levels) for 20 steps,
     launches 3 deposits and gathers, one momentum sums and one step
     (its kicked form) a frame; times of each
     level's deposit, difference solve and gather, the window origins,
     momentum_clean, the whole PM / pm2 / pmn steps, and
     pm.solve_accel_pair against the two solves it batches
 17. pmx (ops/pmx.py) at 1M: bench.py's pmx scene (uniform in [-45,
     45]^3, coarse eps 2, tracked window 32 at eps 0.5, capacity 65,536):
     the compaction's members equal the mask's in slot order; the
     correction (the radix sort of (flag, idx), one difference pass of
     the pairwise kernel with the in-budget count as its live counts,
     index_copy_) against the plain path (two plain passes) within 2e-4
     max|a_x|, the member counts exactly equal; the difference pass timed
     in turns with two passes of the earlier design over the whole
     capacity, beside the plain version and the bound at the members'
     pairs; the whole
     pmx_accel within 1e-4 max|a| + that; capacity 16,384: exactly the
     first 16,384 members by slot order corrected, everyone else 0; times
     of the layers, the compaction by the radix sort beside a prefix-sum
     compaction (cumsum + scatter) and torch.sort, the whole step
 18. the README's pmx command through the CLI: --count 1000000 --steps
     300 --pm --pm2-size 24 --pm2-softening 0.8 --pmx-size 6
     --pmx-softening 0.1: stats and done lines, launches 2 deposits, 2
     gathers, one difference pass of the pairwise kernel (none of the
     single pass), one radix sort (a histogram and a pass launch a
     digit), one momentum sums and one step (its kicked form) a frame, a
     finite final state,
     momentum 0 and the centre of mass in place, the checkpoint's pm2 and
     pmx; psort.LIBRARY_CALLS unchanged through phases 17-18
 19. the persistent cell-sorted PM (ops/pm_persist.py): (1) accel_sorted
     through the kernels against its plain version (accel_sorted_ref) on
     the sorted 1M hollow sphere (G = 128, static box) within 1e-4
     max|a|; a scrambled copy repairs itself (resorts 1, the live slots a
     prefix, disorder 0) and matches the per-frame pm_accel permuted by
     ids within 1e-4 max|a|; (2) the deposit and gather on a cell-sorted
     copy against the original order at 1M and 16,777,216, and at 16M
     against the disorder (the sorted state drifted by sigma cells);
     (2b) the deposit of cell-sorted input against the deposit for any
     order at the main path's persistent 16M states (steps 0, 40, 150,
     and 150 with a quarter of its slots moved): times in turns beside
     the bound and plain, runs, each gap to plain; (4) the main path:
     the CLI with --pm --pm-persist --central-mass 1000 at 1M x 200
     steps: launches (deposit with masses = gather = kicked gather =
     steps, all of them the sorted deposit, no step kernel, one radix
     sort for the mirror and one a repair), a finite
     final state, momentum 0 and the centre of mass in place, the
     repairs; (3) at 1M, 4,194,304 and 16M (dt = 0) the per-frame PM
     step, the steady persistent step, one repair (full, and
     segment-local), the disorder verdict; the crossover (a win by more
     than 5 %): 100 frames of (4)'s collapse through a per-frame and a
     persistent engine from the same start, device time a frame;
     (5) the examples/deep_zoom.py composition (pm2 32 / 0.6 + 8 / 0.2,
     pmx 2 / 0.05, capacity 262,144, holding every member) at 1M: accel
     against
     the per-frame pmx_accel within 1e-4 max|a| + 2e-4 max|a_x|, the
     persistent and the per-frame engine 4 steps each beside three
     per-frame witnesses (two random start orders and the persistent
     mirror's class order; launches; positions after one step within
     G dt^2 times that bar, from step 2 the persistent engine within 5x
     the random witnesses' spread of its class-order twin); (6)
     ensure_identity_order at 1M and 16M (equal to the identity planes)
     beside index_copy_ by ids and a radix sort of the rows by ids;
     (7) Engine(debug_checks=True): clean steps pass, a NaN planted in a
     live slot raises StateValidationError; (8) tools/pm_profile.py's two
     modes at 1M
 20. the mesh path (particle_sim_tpu_torch/parallel/) at world size 1
     under NCCL (a group started here on a file:// store under build/,
     destroyed at the end of the phase): Engine(mesh=make_mesh()) beside
     Engine() from the same state, the mesh engine's launches counted:
     (a) the attractor (dp) at 16,777,216 x 100 steps, equal bit for bit;
     (b) the direct ring with a central mass of 1000 at 65,536 x 20,
     within 1e-4 (JAX's bar); (c) pm_dp at 1M x 20 (G = 128, static box)
     within 1e-4; (d) the persistent PM at 16M x 20 frames of the hollow
     sphere (G 0.01), within JAX's persistent-dp bars (positions 1e-2,
     velocities 0.02 max|v|); (f) render_dp at 16M @ 1920x1080 from the
     persistent carry, equal bit for bit to the single-device compact
     frame of the same carry; (e) the deep-zoom composition of phase 19
     at 1M, one frame, the pmx counts equal and JAX's bars; each mesh
     step timed beside the same step without a mesh (the collectives'
     cost at world size 1); then the attractor CLI at 1M x 100 (frames
     and a checkpoint) without a mesh and with --mesh auto under
     torchrun (python -m torch.distributed.run --standalone
     --nproc_per_node <visible GPUs>) and without it: 'mesh: dp over N
     devices', the done line, the checkpoint equal to the single run's
     bit for bit and the frames within one u8 level; and the persistent
     PM CLI with a central mass under torchrun
 21. the packaging tool (app/release.py --web --native --warm --aot) into
     a directory under build/: every MANIFEST sha256 matches its file,
     the warmed kernel library loads and its step kernel matches the
     plain step (1e-6), the exported step (torch.export) loads and equals
     step_ref on the card
 22. the worked examples (particle_sim_tpu_torch/examples/) through their
     main(argv) at the JAX scripts' documented sizes: attractor 1M x 600,
     disk 1,000,001 x 600, collapse 1M x 600, cluster_core 200,000 x 400
     and deep_zoom 500,000 x 300 without and with --exact, each with
     --out into a temporary directory where it renders: every printed
     line parses and holds only finite numbers, every frame is lit, the
     path's kernels launched (a step once a step: the step kernel, or
     on the single-level PM of disk and collapse the kicked gather), the
     renderer each frame
     took, --exact logs its truncation warning once (members past the
     capacity of 8,192); wall time and host-paced ms a step (a steady
     window of 50 steps of the same scene); then each example's first
     frame at 65,536 on the kernel path against the plain path
     (Method.TORCH, which launches no kernel) from the same start: the
     state after one step at phase 2's bars (attractor) or within dt and
     dt^2 times the accelerations' bar of the phase that holds the same
     solver (phases 11-12, 16, 19), and the frame through the compact
     kernels against their plain versions at phase 3's bars
 23. the PM step's tail in two launches (chip_smoke.phase23, callable
     alone): the momentum sums kernel and the step kernel's kicked form
     at 1M and 16M, unit masses with a live count and masses with a
     shuffled live mask, at 1M also the auto box's scale: the mean
     within 1e-6 of the largest |mean| of a float64 mean, two sums
     launches bit for bit, pos and vel bit for bit the chain it replaced
     (fed the kernel's mean), the kicked form with no clean (the direct
     sum's kick) bit for bit a plain add and the step kernel; times in
     turns against the old chain, with the bytes bound; traced 1M
     auto-box, 1M two-level and 16M persistent engines count
     pm.kick_fused once a step
 24. the kernel path's isolated exact-gradient solve (chip_smoke.phase24,
     callable alone; ops/pm_fft.py, csrc/pm_fft.cu) at G = 128 on the
     16M static-box and 1M auto-box densities and with a level's
     difference spectra: within 1e-5 of max|a| of the plain torch.fft
     chain it replaced, the interleaved layout, two solves bit for bit,
     one pm_solve launch a solve; times in turns against the plain chain
     with the bytes bound (pm_fft.solve_bytes); traced 1M auto-box and
     16M persistent engines count pm.solve.fused and pm_solve once a step
 25. the single-level PM step's tail from the grids (chip_smoke.phase25,
     callable alone): pm_cuda.grid_momentum_mean (csrc/momentum.cu's grid
     instance) and pm_cuda.gather_kick_and_step (csrc/pm.cu's kicked
     gather) against the gather, momentum_mean and clean_kick_and_step
     at the persistent 16M states of --pm-persist --central-mass 1000
     (steps 0, 40, 150; the sphere as generated and in two seeded
     orientations) and the 1M auto box: pos and vel bit for bit the chain
     given the particle mean; the grid sums within GRID_SUMS_ULPS of
     their plain version on the solved grids and on a random field, two
     launches bit for bit; the grid mean within GRID_MEAN_SHARE of the
     particle mean; times in turns
     (the old tail, the new, each launch alone) with the bytes bounds;
     traced engines count pm.kick_gathered once a step on one
     interleaved grid (1M static and auto box, 16M persistent) and never
     with a level or pmx
 26. the refinement windows' bookkeeping in one pass a window
     (chip_smoke.phase26, callable alone; pm2.window_pass,
     csrc/windows.cu) against the plain bookkeeping it replaced on the
     deep-zoom --exact state at 500,000 after 100 steps and a 16M core,
     cluster and halo with masses (two tracked levels and the exact
     window, every window holding members): two passes bit for bit,
     each mask _in_window at the kernel's origin, the origins within
     ORIGIN_ULPS of the plain ones beyond the float32 sums' bar, the
     masks equal but within 1e-5 of a face, the member count; times in
     turns (the step's bookkeeping, the verdict's origins) with the
     bytes bound

The line before the last is a JSON object with one entry per kernel (the
launches of step are phases 4, 16 (the engine), 18, 19, 20, 22, 23 and
25 together; of pairwise phases 8 and 20 (the ring); of pairwise_diff
phases 18, 20 (the deep zoom) and 22; of pm_deposit and pm_gather phase
12's runs (a) and (b), 16, 18, 19, 20, 22, 23 and 25 together (a kicked
gather counts as a gather); of compact
and deposit phases 4, 20 and 22; those of sorted_deposit phases 8 and 12
(b); of radix_hist and radix_pass phases 8, 12 (b), 18, 19, 20, 22,
23 and 25; of pm_solve phases 20, 22, 23 and 24; of window_pass
phases 19, 20, 22, 23, 25 and 26;
those of
pairwise_mxu, hilbert_keys, inlier_box, block_sort and merge_round the
drives of phases 14 and 15); the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
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
# pmx's difference pass a pair (pairwise_kernel<true>): 3 sub, r2 as 3
# fma, rb = r2 + (eps_b^2 - eps_a^2), two rsqrt, the cubes' difference as
# 3 mul and an fma, w = gv * that, 3 fma into the sum -> 22 flops in 15
# FP32 instructions
DIFF_PAIR_FLOPS = 22
DIFF_PAIR_FP32_INSTRS = 15
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


def clocks_under_load(fn, seconds: float = 2.0) -> str:
    """The SM clock and power draw that nvidia-smi reads (every 0.2 s)
    while ``fn`` runs back to back on the card for ``seconds``: 'SM clock
    MHz min / median / max, power W min / median / max (n samples)'."""
    import threading

    import torch

    samples, stop = [], threading.Event()

    def poll():
        while not stop.wait(0.2):
            clk, pw = nvidia_smi("clocks.sm,power.draw").split(",")
            samples.append((float(clk.split()[0]), float(pw.split()[0])))

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    th = threading.Thread(target=poll)
    th.start()
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    stop.set()
    th.join()
    if not samples:
        return "no nvidia-smi sample"
    clks, pws = sorted(c for c, _ in samples), sorted(p for _, p in samples)
    mid = len(samples) // 2
    return (f"SM clock MHz {clks[0]:.0f} / {clks[mid]:.0f} / {clks[-1]:.0f}, "
            f"power W {pws[0]:.1f} / {pws[mid]:.1f} / {pws[-1]:.1f} "
            f"({len(samples)} samples)")


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


def mix_per_pair(mix: dict, rsq_per_pair: int = 1) -> str:
    """A hot loop's mix a pair, as text: 'HMMA 0.50, MUFU 1.00, ...'
    (``rsq_per_pair`` MUFU.RSQ a pair)."""
    n = max(mix["loop_rsq"], 1) / rsq_per_pair
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


def phase19(dev, states) -> dict:
    """Phase 19: the persistent cell-sorted PM (ops/pm_persist.py) on the
    card. ``states``: the hollow-sphere ParticleStates at 1,000,000 and
    16,777,216 of phase 2. -> {"launches": the CLI run's launch counts,
    "ms": the times it measured}."""
    import numpy as np
    import torch

    from particle_sim_tpu_torch.app import cli
    from particle_sim_tpu_torch.core import generate as gen
    from particle_sim_tpu_torch.core.params import (
        PairwiseParams, PMConfig, SimParams,
    )
    from particle_sim_tpu_torch.core.state import ParticleState
    from particle_sim_tpu_torch.engine import Engine
    from particle_sim_tpu_torch.engine import engine as engine_mod
    from particle_sim_tpu_torch.ops import (
        pairwise_cuda, pm, pm2, pm_cuda, pm_persist as pper, pmx, psort,
        step_cuda,
    )
    from particle_sim_tpu_torch.tools import pm_profile
    from particle_sim_tpu_torch.utils import debug

    t_start = time.perf_counter()
    cfg = PMConfig()                  # G = 128, static box, isolated
    g = cfg.grid
    box, cell = pm_cuda.static_box(tuple(cfg.box_min), float(cfg.cell_size),
                                   dev)
    ms = {}

    def rel_err(got, want):
        return float((got - want).abs().max() / want.abs().max())

    # (1) accel_sorted through the kernels against its plain version on
    # the same sorted state; a scrambled copy repairs (resorts rises) and
    # still matches the per-frame pm_accel on the identity order
    st1 = states[1_000_000]
    flat1, na1 = st1.pos.reshape(3, -1), st1.n_active
    n1, live_n1 = flat1.shape[1], int(na1)
    ps = pper.init_sorted(flat1, na1, cfg, vel_flat=st1.vel.reshape(3, -1))
    _, acc_k = pper.accel_sorted(ps, 1.0, cfg, n_active=na1, repair=False)
    e_plain = rel_err(acc_k, pper.accel_sorted_ref(ps, 1.0, cfg,
                                                   n_active=na1))
    gen_t = torch.Generator(device=dev).manual_seed(19)
    perm = torch.randperm(n1, generator=gen_t, device=dev)
    scr = ps._replace(pos=ps.pos[:, perm], vel=ps.vel[:, perm],
                      ids=ps.ids[perm])
    d_scr = int(pper.disorder(pper.state_keys(scr, na1, cfg)))
    rep, acc_s = pper.accel_sorted(scr, 1.0, cfg, n_active=na1)
    e_scr = rel_err(acc_s, pm_cuda.pm_accel(flat1, na1, 1.0, cfg)[
        :, rep.ids.long()])
    prefix = bool((rep.ids[:live_n1] < live_n1).all()
                  and (rep.ids[live_n1:] >= live_n1).all())
    if not (e_plain <= 1e-4 and e_scr <= 1e-4):
        fail(f"accel_sorted: kernels vs plain {e_plain:.3g}, scrambled vs "
             f"per-frame pm_accel {e_scr:.3g} of max|a| (bar 1e-4)")
    if rep.resorts != 1 or not prefix or int(pper.disorder(
            pper.state_keys(rep, na1, cfg))) != 0:
        fail(f"scramble: resorts {rep.resorts}, live prefix {prefix}")
    print(f"phase 19 accel_sorted at {n1} (G = {g}): kernels vs plain "
          f"{e_plain:.3g} max|a|; scrambled (disorder {d_scr}) repaired "
          f"(resorts 1, live slots a prefix, disorder 0), vs per-frame "
          f"pm_accel {e_scr:.3g} (bar 1e-4)")

    # (2) the deposit and gather on a cell-sorted copy against the
    # original order (the per-frame path), and against the disorder
    for n, st in ((1_000_000, st1), (16_777_216, states[16_777_216])):
        flat, na = st.pos.reshape(3, -1), st.n_active
        sp = pper.init_sorted(flat, na, cfg)
        live = sp.ids < na
        grids = pm.solve_accel(pm_cuda.deposit(flat, na, box, cell, g,
                                               periodic=False),
                               cfg, cfg.softening)
        big = n > 2_000_000
        inner = 3 if big else 10
        t = median_ms(
            [lambda: pm_cuda.deposit(flat, na, box, cell, g, periodic=False),
             lambda: pm_cuda.deposit(sp.pos, na, box, cell, g,
                                     periodic=False, live=live),
             lambda: pm_cuda.gather(grids, flat, na, box, cell,
                                    periodic=False),
             lambda: pm_cuda.gather(grids, sp.pos, na, box, cell,
                                    periodic=False, live=live)],
            reps=5, inner=inner, lead_ms=inner * (4.0 if big else 0.5))
        ms[f"deposit {n}"], ms[f"deposit sorted {n}"] = t[0], t[1]
        ms[f"gather {n}"], ms[f"gather sorted {n}"] = t[2], t[3]
        print(f"phase 19 cell order at {n}: deposit {t[0]:.5f} -> sorted "
              f"{t[1]:.5f} ms ({t[0] / t[1]:.2f}x), gather {t[2]:.5f} -> "
              f"sorted {t[3]:.5f} ms ({t[2] / t[3]:.2f}x)")
        sorted16 = (sp, grids, na, flat)      # the 16M case is the last
    sp, grids, na, flat16 = sorted16
    n16 = sp.pos.shape[1]
    live = sp.ids < na
    rows = []
    for sigma in (0.0, 0.01, 0.03, 0.1, 0.3, 1.0, None):
        if sigma is None:              # the original (random) order
            p_d, lv = flat16, None
        else:
            noise = torch.randn(sp.pos.shape, generator=gen_t, device=dev)
            p_d, lv = sp.pos + (sigma * cfg.cell_size) * noise, live
        share = int(pper.disorder(pper.cell_keys(
            p_d, torch.ones(n16, dtype=torch.bool, device=dev) if lv is None
            else lv, cfg))) / int(na)
        t = median_ms(
            [lambda: pm_cuda.deposit(p_d, na, box, cell, g, periodic=False,
                                     live=lv),
             lambda: pm_cuda.gather(grids, p_d, na, box, cell,
                                    periodic=False, live=lv)],
            reps=5, inner=3, lead_ms=12.0)
        rows.append((sigma, share, t[0], t[1]))
    print(f"phase 19 deposit and gather against the disorder at {n16} "
          "(drift sigma in cells: disorder share, deposit ms, gather ms): "
          + " | ".join(f"{'random' if s is None else s}: {d:.4f}, "
                       f"{td:.5f}, {tg:.5f}" for s, d, td, tg in rows))
    ms["disorder rows 16M"] = rows

    # (2b) the deposit of cell-sorted input (pm_cuda.deposit with
    # cell_sorted, the single-level persistent step's) and the deposit for
    # any order, in turns, on the persistent 16M states of the main path's
    # run (--pm-persist --central-mass 1000): the first frame, the
    # collapse (step 40), past the box (step 150), and step 150 with a
    # quarter of its slots moved among themselves; the state's runs
    # (adjacent slots of different lower cells, plain torch on cell_keys)
    # and each kernel's gap to the plain deposit over max|rho|
    del sp, grids, sorted16
    e16 = Engine(n16, device=dev, pm=cfg, pm_persist=True,
                 pairwise=PairwiseParams(1.0, cfg.softening))
    m16 = np.ones(n16, np.float32)
    m16[0] = 1000.0
    e16.set_masses(m16)
    bound16 = bytes_ms(n16 * 17 + g ** 3 * 4)
    done16, sorted_rows = 0, []
    for label in ("step 0", "step 40", "step 150", "step 150 moved"):
        if label == "step 0":
            st16 = pper.init_sorted(e16.state.pos.reshape(3, -1), n16, cfg,
                                    masses=e16._masses_for_capacity())
        elif label == "step 150 moved":
            sel = torch.nonzero(torch.rand(n16, generator=gen_t, device=dev)
                                < 0.25)[:, 0]
            order = torch.arange(n16, device=dev)
            order[sel] = sel[torch.randperm(sel.numel(), generator=gen_t,
                                            device=dev)]
            st16 = st16._replace(pos=st16.pos[:, order].contiguous(),
                                 ids=st16.ids[order],
                                 masses=st16.masses[order].contiguous())
        else:
            while done16 < int(label.split()[1]):
                e16.step(SimParams())
                done16 += 1
            torch.cuda.synchronize()
            st16 = e16._persist
        lv = st16.ids < n16
        key = pper.cell_keys(st16.pos, lv, cfg)
        runs = int((key[1:] != key[:-1]).sum()) + 1
        share = int(pper.disorder(key)) / n16
        kw = dict(periodic=False, masses=st16.masses, live=lv)
        fns = [lambda: pm_cuda.deposit(st16.pos, n16, box, cell, g,
                                       cell_sorted=True, **kw),
               lambda: pm_cuda.deposit(st16.pos, n16, box, cell, g, **kw)]
        plain = pm_cuda.deposit_plain(st16.pos, n16, box, cell, g, **kw)
        scale = float(plain.abs().max())
        gaps = [float((f() - plain).abs().max()) / scale for f in fns]
        t = median_ms(fns, reps=5, inner=5, lead_ms=8.0)
        t_plain = median_ms([lambda: pm_cuda.deposit_plain(
            st16.pos, n16, box, cell, g, **kw)], reps=3, inner=1)[0]
        sorted_rows.append((label, runs, share, t[0], t[1], t_plain,
                            gaps[0], gaps[1]))
        # float32 sums in another order: no further from the plain deposit
        # than the deposit for any order is
        if gaps[0] > max(1e-5, 2 * gaps[1]):
            fail(f"sorted deposit at {n16} {label}: {gaps[0]:.3g} of "
                 f"max|rho| from plain (the deposit for any order "
                 f"{gaps[1]:.3g})")
        print(f"phase 19 sorted deposit at {n16} {label}: {runs} runs, "
              f"disorder {share:.4f}; cell_sorted {t[0]:.5f} ms, any order "
              f"{t[1]:.5f} ms ({t[1] / t[0]:.2f}x), plain {t_plain:.3f} ms, "
              f"bound {bound16:.5f} ms (bytes); gap to plain {gaps[0]:.3g} / "
              f"{gaps[1]:.3g} of max|rho|")
    ms["sorted deposit rows 16M"] = sorted_rows
    del e16, st16, plain, key, lv
    torch.cuda.empty_cache()

    # (4) the persistent main path through the CLI: the shell falls onto
    # a central mass (phase 12 (b) in the persistent mode)
    n_d, steps_d = 1_000_000, 200
    with tempfile.TemporaryDirectory() as tmp:
        final = os.path.join(tmp, "final.npz")
        argv = ["--device", "cuda", "--count", str(n_d), "--steps",
                str(steps_d), "--pm", "--pm-persist", "--central-mass",
                "1000", "--stats-every", "100", "--checkpoint-every",
                str(steps_d), "--checkpoint", final]
        step_cuda.LAUNCHES = pairwise_cuda.LAUNCHES = 0
        pairwise_cuda.DIFF_LAUNCHES = 0
        pm_cuda.DEPOSIT_LAUNCHES = pm_cuda.DEPOSIT_MASS_LAUNCHES = 0
        pm_cuda.DEPOSIT_SORTED_LAUNCHES = pm_cuda.GATHER_LAUNCHES = 0
        pm_cuda.KICK_GATHER_LAUNCHES = 0
        psort.RADIX_HIST_LAUNCHES = psort.RADIX_PASS_LAUNCHES = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc_code = cli.main(argv)
        wall_d = time.perf_counter() - t0
        got = {"pm_deposit": pm_cuda.DEPOSIT_LAUNCHES,
               "pm_deposit_mass": pm_cuda.DEPOSIT_MASS_LAUNCHES,
               "pm_deposit_sorted": pm_cuda.DEPOSIT_SORTED_LAUNCHES,
               "pm_gather": pm_cuda.GATHER_LAUNCHES,
               "pm_kick_gather": pm_cuda.KICK_GATHER_LAUNCHES,
               "pairwise": pairwise_cuda.LAUNCHES,
               "pairwise_diff": pairwise_cuda.DIFF_LAUNCHES,
               "radix_hist": psort.RADIX_HIST_LAUNCHES,
               "radix_pass": psort.RADIX_PASS_LAUNCHES,
               "step": step_cuda.LAUNCHES}
        text = out.getvalue()
        for ln in text.splitlines():
            print(f"  cli (persistent pm): {ln}")
        if rc_code != 0:
            fail(f"persistent pm cli returned {rc_code}")
        lines = [json.loads(ln) for ln in text.strip().splitlines()]
        with np.load(final) as z:
            p_end, v_end, m_end = z["positions"], z["velocities"], z["masses"]
    # one sort makes the mirror; every repair is one sort more
    repairs = got["radix_hist"] - 1
    want = {"pm_deposit": 0, "pm_deposit_mass": steps_d,
            "pm_deposit_sorted": steps_d,
            "pm_gather": steps_d, "pm_kick_gather": steps_d, "pairwise": 0,
            "pairwise_diff": 0, "radix_hist": repairs + 1,
            "radix_pass": psort.radix_digits() * (repairs + 1),
            "step": 0}
    if got != want or lines[-1].get("done") is not True:
        fail(f"the persistent pm cli path missed a kernel: launches {got}, "
             f"expected {want}")
    # the collapse scatters the cell order: a run that never repairs has a
    # dead trigger
    if repairs < 1:
        fail(f"persistent pm cli: {repairs} repairs in {steps_d} steps of a "
             f"collapse (the repair trigger never fired)")
    if not (np.isfinite(p_end).all() and np.isfinite(v_end).all()):
        fail("persistent pm cli: final state not finite")
    mom_d, com_d = momentum_and_com(gen.generate(n_d)[0].astype(np.float64),
                                    p_end, v_end, m_end.astype(np.float64))
    if not (mom_d < 1e-3 and com_d < 0.5):
        fail(f"persistent pm cli: |P| / sum m|v| = {mom_d:.3g} (bar 1e-3), "
             f"centre of mass moved {com_d:.3g} (bar 0.5)")
    ms["cli wall"] = wall_d
    print(f"phase 19 persistent pm main path: cli {n_d} x {steps_d} steps "
          f"(--pm-persist --central-mass 1000) in {wall_d:.2f} s, "
          f"{lines[-1].get('update_ms')} ms a step (host), {repairs} "
          f"repairs (resorts), finite final state, |P| / sum m|v| "
          f"{mom_d:.3g}, centre of mass moved {com_d:.3g}, launches {got}")

    # the trigger on a live engine: a scrambled mirror is repaired within
    # CHECK_EVERY + 1 frames when the host waits for every frame (no host
    # lead: the verdict is read at the first frame after the next check),
    # and at all when it does not (the lag then grows by the host's lead)
    e_tr = Engine(1_000_000, device=dev, pm=cfg, pm_persist=True)
    lags = []
    for synced in (True, False):
        for _ in range(3):
            e_tr.step(SimParams())
        torch.cuda.synchronize()
        mir = e_tr._persist
        perm_t = torch.randperm(mir.pos.shape[1], generator=gen_t, device=dev)
        e_tr._persist = mir._replace(
            pos=mir.pos[:, perm_t], vel=mir.vel[:, perm_t],
            ids=mir.ids[perm_t], col24=mir.col24[perm_t])
        before, frames = e_tr.resorts, 0
        while e_tr.resorts == before and frames < 400:
            e_tr.step(SimParams())
            frames += 1
            if synced:
                torch.cuda.synchronize()
        lags.append(frames)
    if lags[0] > pper.CHECK_EVERY + 1 or e_tr.resorts != 2:
        fail(f"repair trigger: a scrambled mirror repaired after {lags} "
             f"frames (synchronized, not; bar {pper.CHECK_EVERY + 1} "
             f"synchronized), {e_tr.resorts} repairs (want 2)")
    print(f"phase 19 repair trigger: a scrambled 1M mirror repaired "
          f"{lags[0]} frames later with the host waiting each frame (bar "
          f"CHECK_EVERY + 1 = {pper.CHECK_EVERY + 1}), {lags[1]} frames "
          f"later with the host running ahead")
    del e_tr

    # (3) at 1M, 4M and 16M: the per-frame PM step, the steady persistent
    # step, one repair (full, and the JAX package's segment-local tier,
    # built here as a composite key (segment << key bits | cell key), one
    # 8-bit digit more for the radix sort, with the same payload gathers)
    # and the disorder verdict at dt = 0 (the same work every call); then
    # the crossover: 100
    # frames of (4)'s collapse onto a central mass of 1000, from the same
    # start, through a per-frame and a persistent engine (repairs and
    # verdicts included), device time from the first frame's enqueue to
    # the last one's end
    pv0 = torch.from_numpy(SimParams(delta_time=0.0).pack()).to(dev)
    pp0 = torch.from_numpy(PairwiseParams(1.0, cfg.softening).pack()).to(dev)
    seg = 65536                       # slots a segment (the JAX tier 1)
    key_bits = (g ** 3).bit_length()

    def segment_repair(sp, na):
        slot = torch.arange(sp.pos.shape[1], dtype=torch.int32, device=dev)
        key = ((slot // seg) << key_bits) | pper.state_keys(sp, na, cfg)
        order = psort.sort((key, slot))[1].long()
        return tuple(t.index_select(-1, order)
                     for t in (sp.pos, sp.vel, sp.ids))

    wins = []
    for n in (1_000_000, 4_194_304, 16_777_216):
        st = states.get(n) or ParticleState.from_arrays(
            *gen.generate(n), device=dev)
        flat, na = st.pos.reshape(3, -1), st.n_active
        pk, vk = st.pos.clone(), st.vel.clone()
        sp = pper.init_sorted(flat, na, cfg, vel_flat=st.vel.reshape(3, -1))
        tiled = sp.pos.shape[1] % seg == 0
        big = n > 2_000_000
        inner = 3 if big else 10
        fns = [lambda: pm_cuda.step_pm(pk, vk, pv0, pp0, na, cfg),
               lambda: pper.step_sorted(sp, pv0, pp0, na, cfg, repair=False),
               lambda: pper.repair_state(sp, na, cfg),
               lambda: pper.needs_repair(sp, na, cfg)]
        if tiled:
            fns.append(lambda: segment_repair(sp, na))
            # each segment of a drifted state sorted on its own, every
            # particle kept with its payloads
            drift = sp._replace(pos=sp.pos + 0.5 * cfg.cell_size * torch.randn(
                sp.pos.shape, generator=gen_t, device=dev))
            p_l, v_l, ids_l = segment_repair(drift, na)
            k_l = pper.cell_keys(p_l, ids_l < na, cfg).view(-1, seg)
            inv = drift.ids.long().argsort()
            if not (bool((k_l[:, 1:] >= k_l[:, :-1]).all())
                    and torch.equal(ids_l.view(-1, seg).sort(1)[0],
                                    drift.ids.view(-1, seg).sort(1)[0])
                    and torch.equal(p_l, drift.pos[:, inv[ids_l.long()]])):
                fail(f"segment-local repair at {n}: a segment out of order")
        t = median_ms(fns, reps=5, inner=inner,
                      lead_ms=inner * (8.0 if big else 2.0))
        per_frame, steady, full, verdict = t[:4]
        local = t[4] if tiled else float("nan")
        masses_n = np.ones(n, np.float32)
        masses_n[0] = 1000.0
        dyn = {}
        for persist in (False, True):
            e = Engine(1024, device=dev, pm=cfg, pm_persist=persist)
            e.state = ParticleState(pos=st.pos.clone(), vel=st.vel.clone(),
                                    init_color=st.init_color, n_active=na)
            e.set_masses(masses_n)
            for _ in range(5):           # the persistent one makes its mirror
                e.step(SimParams())
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            for _ in range(100):
                e.step(SimParams())
            end.record()
            end.synchronize()
            dyn[persist] = (start.elapsed_time(end) / 100, e.resorts)
            del e
        ms[f"steps {n}"] = (per_frame, steady, full, local, verdict, dyn)
        # a win must clear the 5 % that such times spread between calls
        if dyn[True][0] < 0.95 * dyn[False][0]:
            wins.append(n)
        print(f"phase 19 steps at {n} (dt = 0): per-frame PM step "
              f"{per_frame:.5f} ms | persistent steady {steady:.5f} | repair "
              f"{full:.5f} (segment-local {local:.5f}) | disorder verdict "
              f"{verdict:.5f}; 100 collapse frames: per-frame "
              f"{dyn[False][0]:.5f} ms a frame, persistent {dyn[True][0]:.5f}"
              f" ({dyn[True][0] / dyn[False][0]:.3f} of it, "
              f"{dyn[True][1]} repairs)")
    print(f"phase 19 crossover: persistent wins by more than 5 % at "
          f"{wins or 'no count'} of 1M / 4M / 16M; the engine's "
          f"PERSIST_AUTO_MIN_N is {engine_mod.PERSIST_AUTO_MIN_N}")
    # "auto" goes persistent from the smallest count that wins, and
    # never when none does
    if (min(wins) if wins else None) != engine_mod.PERSIST_AUTO_MIN_N:
        fail(f"crossover: persistent wins at {wins}, but PERSIST_AUTO_MIN_N "
             f"is {engine_mod.PERSIST_AUTO_MIN_N}")

    # (5) the examples/deep_zoom.py composition (a pm2 tuple, pm_persist,
    # pmx) at 1M against the per-frame pmn / pmx engine on the same start;
    # the capacity holds every member, so both correct the same pairs. Two
    # more per-frame engines, the witnesses, start from the same particles
    # in two random orders: they differ from the first in f32 summation
    # order only. A third starts in the persistent mirror's own class
    # order (spatially sorted slots, the order of the persistent engine's
    # deposits and pair sums); the persistent engine differs from it in
    # the deposits' rounding only. The scene is violent (the core's max|a|
    # G dt^2 is ~4.5, so the window loses most of its members in a step):
    # such differences grow by ~270x in the second step, so from step 2
    # on the bar is set by the random witnesses, around the class-order
    # one. The window origins' float64 sums (csrc/windows.cu) do not move
    # with the order, so a random order no longer spans the class order's
    # own rounding: the persistent engine is held to its own order's twin
    n_z, steps_z = 1_000_000, 4
    rng = np.random.default_rng(13)

    def ball(k, radius, off):
        d = rng.normal(size=(k, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        r = radius * rng.random(k).astype(np.float32) ** (1 / 3)
        return d * r[:, None] + off

    center = np.float32([14.0, 6.0, -4.0])
    zpos = np.concatenate([ball(n_z // 4, 0.8, center),
                           ball(n_z // 4, 4.0, center),
                           ball(n_z - n_z // 2, 40.0, 0.0)])
    perms = [rng.permutation(n_z) for _ in range(2)]
    zcfg = PMConfig(softening=3.0)
    levels = (pm2.PM2Config(window_min=None, window_size=32.0,
                            softening=0.6),
              pm2.PM2Config(window_min=None, window_size=8.0,
                            softening=0.2))
    zx = pmx.PMXConfig(window_size=2.0, softening=0.05, capacity=262144)

    def zoom_engine(persist, start):
        e = Engine(n_z, device=dev, pm=zcfg,
                   pairwise=PairwiseParams(0.05, 3.0), pm2=levels, pmx=zx,
                   pm_persist=persist)
        e.state = ParticleState.from_arrays(
            start, np.zeros_like(start), np.full_like(start, 0.7),
            device=dev, capacity=e.capacity)
        return e

    engines = [zoom_engine(True, zpos), zoom_engine(False, zpos)]
    e_p, e_f = engines
    zflat, zna = e_f.state.pos.reshape(3, -1), e_f.state.n_active
    zs = pper.init_sorted_multi(zflat, zna, zcfg, levels)
    # the persistent mirror's class order (its first frame sorts the same
    # start by the same keys; no repair follows in 4 steps)
    perms.append(zs.ids[:n_z].long().cpu().numpy())
    engines += [zoom_engine(False, zpos[p]) for p in perms]
    e_c = engines[-1]
    _, acc_zp, n_zp = pper.accel_sorted_multi(zs, 1.0, zcfg, levels,
                                              n_active=zna, cfgx=zx,
                                              repair=False)
    acc_zf, n_zf = pmx.pmx_accel(zflat, zna, 1.0, zcfg, levels, zx)
    # the per-frame field of the start in the class order, in slot order
    acc_zc = pmx.pmx_accel(e_c.state.pos.reshape(3, -1), zna, 1.0, zcfg,
                           levels, zx)[0][:, :n_z]
    e_zc = float((acc_zp[:, :n_z] - acc_zc).abs().max())
    # phase 16's bar on the mesh part, phase 17's on the exact correction
    a_x = acc_zf - pm2.pmn_accel(zflat, zna, 1.0, zcfg, levels)
    e_z = float((acc_zp - acc_zf[:, zs.ids.long()]).abs().max())
    bar_z = (1e-4 * float(acc_zf.abs().max())
             + 2e-4 * float(a_x.abs().max()))
    if int(n_zp) != int(n_zf) or int(n_zf) > zx.capacity or e_z > bar_z:
        fail(f"deep zoom composition: members {int(n_zp)} / {int(n_zf)} "
             f"(capacity {zx.capacity}), max |da| {e_z:.3g} (bar "
             f"{bar_z:.3g})")

    def origins(e):
        """f32[3, 3]: the two levels' window origins and the exact
        window's, as the engine's next frame computes them from its
        planes (the persistent one's in slot order)."""
        if e is e_p:
            m = e._persist
            pos, live, masses = m.pos, m.ids < zna, m.masses
        else:
            pos = e.state.pos.reshape(3, -1)
            live, masses = pm.live_mask(pos.shape[1], zna, dev), None
        wm = pm2._nested_wmins(pos, live, zcfg, levels, masses)
        lv_live = pm2._in_window(pos, wm[-1], levels[-1].window_size,
                                 levels[-1].margin) & live
        wx = pm2.clamp_nested(pm2.window_min(pos, None, zx, masses,
                                             live=lv_live),
                              wm[-1], levels[-1], zx.window_size)
        return torch.stack([*wm, wx])

    zp = SimParams(delta_time=0.016, gravity=0.0)
    step_cuda.LAUNCHES = pairwise_cuda.LAUNCHES = 0
    pairwise_cuda.DIFF_LAUNCHES = 0
    pm_cuda.DEPOSIT_LAUNCHES = pm_cuda.GATHER_LAUNCHES = 0
    # per step, for the persistent engine and each witness against the
    # per-frame one: max |dp| in identity order, the window origins' max
    # difference, the member count's difference; and the persistent
    # engine against the class-order witness
    dz, dw, dc, d_cf, d_org, members = [], [], [], [], [], []
    for _ in range(steps_z):
        for e in engines:
            e.step(zp)
        p_f, p_p = e_f.state.positions(), e_p.state.positions()
        d_pos = [float(np.abs(p_p - p_f).max())]
        for e, p in zip(engines[2:], perms):
            p_w = np.empty_like(p_f)
            p_w[p] = e.state.positions()
            d_pos.append(float(np.abs(p_w - p_f).max()))
        dz.append(d_pos[0])
        dw.append(max(d_pos[1:3]))
        d_cf.append(d_pos[3])
        dc.append(float(np.abs(p_p - p_w).max()))
        o_f = origins(e_f)
        d_org.append([float((origins(e) - o_f).abs().max())
                      for e in engines if e is not e_f])
        members.append([e.pmx_member_count()[0] for e in engines])
    z_launch = {"pm_deposit": pm_cuda.DEPOSIT_LAUNCHES,
                "pm_gather": pm_cuda.GATHER_LAUNCHES,
                "pairwise": pairwise_cuda.LAUNCHES,
                "pairwise_diff": pairwise_cuda.DIFF_LAUNCHES,
                "step": step_cuda.LAUNCHES}
    # one step from rest moves a particle by a G dt^2: the accelerations'
    # bar, plus a few f32 roundings of the positions (|p| < 64)
    bar_p = zp.delta_time ** 2 * 0.05 * bar_z + 64 * 2.0 ** -20
    print(f"phase 19 deep zoom composition at {n_z} (pm2 32 / 0.6, 8 / 0.2, "
          f"pmx 2 / 0.05, capacity {zx.capacity}, G 0.05): {int(n_zf)} "
          f"members in both, persistent vs per-frame accel (G = 1) {e_z:.3g}"
          f" (bar {bar_z:.3g}, max|a| {float(acc_zf.abs().max()):.4g}), vs "
          f"per-frame in its class order {e_zc:.3g}; positions after step 1 "
          f"(bar {bar_p:.3g}) and on: persistent vs per-frame "
          f"{[f'{d:.3g}' for d in dz]}, random witnesses' worst (per-frame, "
          f"permuted starts) {[f'{d:.3g}' for d in dw]}, class-order "
          f"witness vs per-frame {[f'{d:.3g}' for d in d_cf]}, persistent "
          f"vs the class-order witness {[f'{d:.3g}' for d in dc]}; window "
          f"origins' max difference a step (persistent, witnesses) "
          f"{[[f'{d:.3g}' for d in ds] for ds in d_org]}; members "
          f"(persistent, per-frame, witnesses) {members}; launches of the "
          f"five engines {z_launch}, repairs {e_p.resorts}")
    frames_z = steps_z * len(engines)
    if z_launch != {"pm_deposit": 3 * frames_z, "pm_gather": 3 * frames_z,
                    "pairwise": 0, "pairwise_diff": frames_z,
                    "step": frames_z}:
        fail(f"deep zoom engines: launches {z_launch}")
    if (not max(dz[0], dw[0], dc[0]) <= bar_p
            or not e_p.persist_resolved()):
        fail(f"deep zoom: persistent / witness vs per-frame positions differ "
             f"by {dz[0]:.3g} / {dw[0]:.3g} after 1 step, the persistent vs "
             f"the class-order witness by {dc[0]:.3g} (bar {bar_p:.3g})")
    # from step 2: the persistent engine within 5x the random witnesses'
    # worst of its class-order twin; origins within a few f32 roundings
    # of |p| < 64 summed over 1M (any order); member counts within 5x the
    # witnesses' worst difference (at least 1)
    for k in range(1, steps_z):
        d_m = [abs(m - members[k][1]) for m in members[k]]
        if (dc[k] > 5.0 * dw[k] or max(d_org[k]) > 64 * 2.0 ** -18
                or d_m[0] > 5 * max(1, *d_m[2:])):
            fail(f"deep zoom step {k + 1}: persistent vs the class-order "
                 f"witness positions {dc[k]:.3g} (bar 5 x the random "
                 f"witnesses' {dw[k]:.3g}; vs per-frame {dz[k]:.3g}), "
                 f"origins {d_org[k]} (bar {64 * 2.0 ** -18:.3g}), members "
                 f"{members[k]}")

    # (6) ensure_identity_order (pm_persist.unsort: the inverse permutation
    # of ids, then index_select) at 1M and 16M, against a scatter by ids
    # (index_copy_) and the JAX package's way, a sort of the rows by ids
    # (psort.sort: the radix kernels), in turns
    for n, st in ((1_000_000, st1), (16_777_216, states[16_777_216])):
        e_id = Engine(1024, device=dev)
        e_id.state = st
        sp_id = pper.init_sorted(st.pos.reshape(3, -1), st.n_active, cfg,
                                 vel_flat=st.vel.reshape(3, -1))
        ids_l = sp_id.ids.long()
        n_id = ids_l.shape[0]
        dp, dv = torch.empty_like(sp_id.pos), torch.empty_like(sp_id.vel)
        ids_o = torch.empty_like(sp_id.ids)

        def rebuild():
            e_id._persist, e_id._identity_dirty = sp_id, True
            e_id.ensure_identity_order()

        def scatter():
            dp.index_copy_(1, ids_l, sp_id.pos)
            dv.index_copy_(1, ids_l, sp_id.vel)

        def sort_by_ids():
            for src, dst in ((sp_id.pos, dp), (sp_id.vel, dv)):
                psort.sort((sp_id.ids, *src), out=(ids_o, *dst))

        rebuild()
        if not (torch.equal(e_id.state.pos.reshape(3, -1),
                            st.pos.reshape(3, -1))
                and torch.equal(e_id.state.vel, st.vel)):
            fail(f"ensure_identity_order at {n}: not the identity order")
        big = n > 2_000_000
        t = median_ms([rebuild, scatter, sort_by_ids], reps=5, inner=3,
                      lead_ms=20.0 if big else 3.0)
        ms[f"identity {n}"] = t
        print(f"phase 19 ensure_identity_order at {n_id}: {t[0]:.5f} ms "
              f"(the inverse permutation, index_select) | index_copy_ by "
              f"ids {t[1]:.5f} | radix sort of the rows by ids "
              f"{t[2]:.5f} | bound {bytes_ms(n_id * (24 + 24 + 4)):.5f} ms "
              "(pos and vel read and written, ids read)")

    # (7) Engine(debug_checks=True): clean steps pass, a NaN planted in a
    # live slot of the sorted mirror raises StateValidationError
    e_dbg = Engine(1_000_000, device=dev, pm=cfg, pm_persist=True,
                   debug_checks=True)
    for _ in range(3):
        e_dbg.step(SimParams())
    e_dbg._persist.vel[0, 10] = float("nan")
    try:
        e_dbg.step(SimParams())
    except debug.StateValidationError as exc:
        print(f"phase 19 debug_checks: 3 clean steps passed, a NaN planted "
              f"in slot 10 raised StateValidationError({exc})")
    else:
        fail("debug_checks: a NaN in the state did not raise")

    # (8) tools/pm_profile.py's two modes at 1M
    for argv in (["1000000"], ["pmn", "1000000"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            prof = pm_profile.main(argv)
        ms[f"pm_profile {argv[0]}"] = prof
        print(f"phase 19 pm_profile {' '.join(argv)}: " + " | ".join(
            f"{k.strip()} {v:.5f}" for k, v in prof.items()) + " ms")
    print(f"phase 19 done in {time.perf_counter() - t_start:.1f} s")
    return {"launches": got, "ms": ms}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from particle_sim_tpu_torch.ops import (
        pairwise_cuda, pm2, pm_cuda, pm_fft, psort, step_cuda,
    )
    from particle_sim_tpu_torch.render import raster_compact as rc
    from particle_sim_tpu_torch.render import raster_sorted as rs

    return {"step": step_cuda.LAUNCHES, "pairwise": pairwise_cuda.LAUNCHES,
            "pairwise_diff": pairwise_cuda.DIFF_LAUNCHES,
            "pm_deposit": pm_cuda.DEPOSIT_LAUNCHES
            + pm_cuda.DEPOSIT_MASS_LAUNCHES,
            "pm_deposit_sorted": pm_cuda.DEPOSIT_SORTED_LAUNCHES,
            "pm_gather": pm_cuda.GATHER_LAUNCHES,
            "pm_momentum": pm_cuda.MOMENTUM_LAUNCHES,
            "pm_kick_fused": pm_cuda.KICK_FUSED_LAUNCHES,
            "pm_kick_gather": pm_cuda.KICK_GATHER_LAUNCHES,
            "pm_solve": pm_fft.LAUNCHES,
            "radix_hist": psort.RADIX_HIST_LAUNCHES,
            "radix_pass": psort.RADIX_PASS_LAUNCHES,
            "compact": rc.COMPACT_LAUNCHES, "deposit": rc.DEPOSIT_LAUNCHES,
            "sorted_deposit": rs.LAUNCHES,
            "window_pass": pm2.WINDOW_LAUNCHES}


def zero_launches() -> None:
    from particle_sim_tpu_torch.ops import (
        pairwise_cuda, pm2, pm_cuda, pm_fft, psort, step_cuda,
    )
    from particle_sim_tpu_torch.render import raster_compact as rc
    from particle_sim_tpu_torch.render import raster_sorted as rs

    step_cuda.LAUNCHES = pairwise_cuda.LAUNCHES = 0
    pairwise_cuda.DIFF_LAUNCHES = 0
    pm_cuda.DEPOSIT_LAUNCHES = pm_cuda.DEPOSIT_MASS_LAUNCHES = 0
    pm_cuda.DEPOSIT_SORTED_LAUNCHES = pm_cuda.GATHER_LAUNCHES = 0
    pm_cuda.MOMENTUM_LAUNCHES = pm_cuda.KICK_FUSED_LAUNCHES = 0
    pm_cuda.KICK_GATHER_LAUNCHES = 0
    pm_fft.LAUNCHES = 0
    psort.RADIX_HIST_LAUNCHES = psort.RADIX_PASS_LAUNCHES = 0
    rc.COMPACT_LAUNCHES = rc.DEPOSIT_LAUNCHES = rs.LAUNCHES = 0
    pm2.WINDOW_LAUNCHES = 0


def phase23(dev) -> dict:
    """Phase 23: the PM step's tail in two launches, the momentum sums
    (pm_cuda.momentum_mean, csrc/momentum.cu) and the step kernel's kicked
    form with the clean and the scale (pm_cuda.clean_kick_and_step,
    csrc/step.cu), at 1M and 16M on the hollow sphere's raw PM
    acceleration (G = 128): unit masses with a live count, and masses
    with a shuffled live mask; at 1M also the auto box's G / h^2 scale.
    The kernel's mean within 1e-6 of the largest |mean| of a float64 mean
    (and two launches bit for bit); pos and vel after one step bit for
    bit the chain it replaced (pm.momentum_clean's passes with the
    kernel's mean, the scale, vel += a*dt, the step kernel); the kicked
    form with no clean and no scale (step_cuda.kick_step, the direct
    sum's kick) bit for bit a plain add and the step kernel. Times with
    CUDA events, in turns: the old chain (momentum_clean, the scale, the
    add, the step kernel) against the two launches, each launch alone,
    and the bytes bound beside them. Then traced engines (the 1M auto
    box, the 1M two-level PM, the 16M persistent PM) count pm.kick_fused
    once a step. Callable alone after
    ``cuda_build.library()``. -> {"launches", "ms"}."""
    import numpy as np
    import torch

    from particle_sim_tpu_torch.core import generate as gen
    from particle_sim_tpu_torch.core.params import (
        P_DT, PairwiseParams, PMConfig, SimParams,
    )
    from particle_sim_tpu_torch.core.state import ParticleState
    from particle_sim_tpu_torch.engine import Engine
    from particle_sim_tpu_torch.ops import pm, pm2, pm_cuda, step_cuda
    from particle_sim_tpu_torch.utils import trace

    t_start = time.perf_counter()
    cfg = PMConfig()                          # G = 128, static box
    pv = torch.from_numpy(SimParams(
        delta_time=0.016, is_mouse_dragging=True,
        mouse_position=(10.0, 5.0, -8.0), mouse_force=40.0,
        mouse_radius=30.0).pack()).to(dev)
    ms, total = {}, {}

    def old_chain(pos, vel, acc, mean, live_f, scale):
        a = (acc - mean[:, None]) * live_f[None]
        a = scale * a
        vel.add_(a.reshape(vel.shape) * pv[P_DT])
        return step_cuda.step(pos, vel, pv)

    for n in (1_000_000, 16_777_216):
        pos_h, _, col = gen.generate(n)
        vel_h = np.random.default_rng(23).normal(size=pos_h.shape) * 3.0
        st = ParticleState.from_arrays(pos_h, vel_h.astype(np.float32), col,
                                       device=dev)
        del pos_h, vel_h, col
        flat, na = st.pos.reshape(3, -1), st.n_active
        cap = flat.shape[1]
        gen_t = torch.Generator(device=dev).manual_seed(23)
        shuffled = torch.randperm(cap, generator=gen_t, device=dev) < na
        masses = 0.5 + torch.rand(cap, generator=gen_t, device=dev)
        masses[0] = 1000.0
        g = torch.tensor([0.7, cfg.softening], device=dev)[0]
        cases = [("count", None, None, cfg), ("masses+live", masses,
                                               shuffled, cfg)]
        if n == 1_000_000:
            cases.append(("auto_box", None, None,
                          PMConfig(auto_box=True)))
        for label, m, live, c in cases:
            acc, cell = pm_cuda.accel_raw(flat, na, c, masses=m, live=live)
            scale = g if cell is None else g / (cell * cell)
            live_f = (pm.live_mask(cap, na, dev) if live is None
                      else live).to(torch.float32)
            zero_launches()
            mean = pm_cuda.momentum_mean(acc, na, masses=m, live=live)
            again = pm_cuda.momentum_mean(acc, na, masses=m, live=live)
            w = live_f.double() * (1.0 if m is None else m.double())
            exact = (acc.double() * w).sum(dim=1) / w.sum()
            plain = pm.momentum_mean(acc, na, m, live=live)
            bar = 1e-6 * float(exact.abs().max())
            gap = float((mean.double() - exact).abs().max())
            gap_plain = float((plain.double() - exact).abs().max())
            if not torch.equal(mean, again):
                fail(f"phase 23 {label} n={n}: two sums launches differ")
            if gap > bar:
                fail(f"phase 23 {label} n={n}: mean {gap:.3g} from float64 "
                     f"(bar {bar:.3g})")
            pk, vk = st.pos.clone(), st.vel.clone()
            pm_cuda.clean_kick_and_step(pk, vk, acc, pv, mean, na, g,
                                        live=live, cell=cell)
            pp_, vp_ = st.pos.clone(), st.vel.clone()
            old_chain(pp_, vp_, acc, mean, live_f, scale)
            torch.cuda.synchronize()
            got = launch_counts()
            if (got["pm_momentum"], got["pm_kick_fused"], got["step"]) != (
                    2, 1, 2):
                fail(f"phase 23 {label} n={n}: launches {got}")
            if not (torch.equal(pk, pp_) and torch.equal(vk, vp_)):
                fail(f"phase 23 {label} n={n}: the fused step differs from "
                     f"the chain by {float((pk - pp_).abs().max()):.3g} / "
                     f"{float((vk - vp_).abs().max()):.3g}")
            print(f"phase 23 {label} n={n}: mean {mean.tolist()}, "
                  f"{gap:.3g} from float64 (bar {bar:.3g}; torch's float32 "
                  f"sums {gap_plain:.3g}); two sums launches equal; pos and "
                  f"vel == the chain bit for bit")
            if label == "count":
                # the direct sum's kick: no clean, no scale
                pk, vk = st.pos.clone(), st.vel.clone()
                step_cuda.kick_step(pk.view(3, -1, 128),
                                    vk.view(3, -1, 128), acc, pv)
                pp_, vp_ = st.pos.clone(), st.vel.clone()
                vp_.add_(acc.reshape(vp_.shape) * pv[P_DT])
                step_cuda.step(pp_, vp_, pv)
                if not (torch.equal(pk, pp_) and torch.equal(vk, vp_)):
                    fail(f"phase 23 kick_step n={n}: differs from a "
                         f"plain add and the step kernel")
            # times in turns: the old chain, the two launches, each alone
            tp, tv = st.pos.clone(), st.vel.clone()
            fns = [
                lambda: old_chain(tp, tv, acc, pm.momentum_mean(
                    acc, na, m, live=live), live_f, scale),
                lambda: pm_cuda.clean_kick_and_step(
                    tp, tv, acc, pv, pm_cuda.momentum_mean(
                        acc, na, masses=m, live=live), na, g, live=live,
                    cell=cell),
                lambda: pm_cuda.momentum_mean(acc, na, masses=m, live=live),
                lambda: pm_cuda.clean_kick_and_step(
                    tp, tv, acc, pv, mean, na, g, live=live, cell=cell)]
            t = median_ms(fns, reps=7, inner=10, lead_ms=3.0)
            live_b = 0 if live is None else 1
            sums_b = cap * (12 + live_b + (0 if m is None else 4))
            kick_b = cap * (12 + live_b + 24 + 24)
            ms[f"{label} n={n}"] = t
            print(f"phase 23 {label} n={n} times (ms, in turns): old chain "
                  f"{t[0]:.5f} (momentum_clean's passes, the scale, the "
                  f"add, the step kernel), two launches {t[1]:.5f}; sums "
                  f"alone {t[2]:.5f} (bound {bytes_ms(sums_b):.5f}: "
                  f"{sums_b / 1e6:.1f} MB), kicked step alone {t[3]:.5f} "
                  f"(bound {bytes_ms(kick_b):.5f}: {kick_b / 1e6:.1f} MB)")
            del acc, tp, tv, pk, vk, pp_, vp_
        del st, flat, shuffled, masses
        torch.cuda.empty_cache()

    # traced engines: pm.kick_fused once a step
    runs = (("pm1m autobox", dict(particle_count=1_000_000,
                                  pm=PMConfig(auto_box=True),
                                  pairwise=PairwiseParams(0.08, 2.0)),
             SimParams(delta_time=0.004)),
            ("pm1m two-level", dict(particle_count=1_000_000, pm=cfg,
                                    pm2=pm2.PM2Config(None, 32.0, 0.75),
                                    pairwise=PairwiseParams(1.0, 3.0)),
             SimParams(delta_time=0.004)),
            ("pm16m persist", dict(particle_count=16_777_216, pm=cfg,
                                   pm_persist=True,
                                   pairwise=PairwiseParams(1.0, 2.0)),
             SimParams()))
    for label, kw, params in runs:
        e = Engine(device=dev, **kw)
        e.step(params)
        torch.cuda.synchronize()
        zero_launches()
        trace.reset()
        trace.enable()
        try:
            for _ in range(10):
                e.step(params)
            recs = trace.records()
            counts = trace.counters()
        finally:
            trace.disable()
            trace.reset()
        got = launch_counts()
        steps = sum(1 for r in recs if r.name == "engine.step")
        # the sorted deposit only on the single-level persistent state
        sorted_want = 10 if "persist" in label else 0
        if (steps, counts.get("pm.kick_fused"), got["pm_momentum"],
                got["pm_kick_fused"], counts.get("pm.deposit.sorted", 0),
                got["pm_deposit_sorted"]) != (10, 10, 10, 10, sorted_want,
                                              sorted_want):
            fail(f"phase 23 {label}: engine.step {steps}, pm.kick_fused "
                 f"{counts.get('pm.kick_fused')}, pm.deposit.sorted "
                 f"{counts.get('pm.deposit.sorted')}, launches {got}")
        kick_ms = [r.device_ms for r in recs
                   if r.name in ("pm.momentum", "pm.kick")]
        print(f"phase 23 {label} engine x 10 traced: pm.kick_fused 10, "
              f"launches {got}; pm.momentum + pm.kick "
              f"{sum(kick_ms) / 10:.4f} device ms a step")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        del e
        torch.cuda.empty_cache()
    print(f"phase 23 done in {time.perf_counter() - t_start:.1f} s")
    return {"launches": total, "ms": ms}


def phase24(dev) -> dict:
    """Phase 24: the isolated exact-gradient solve of the kernel path
    (ops/pm_fft.py, csrc/pm_fft.cu: the pad, product and interleave
    kernels around four cuFFT plans) at G = 128 on the main path's
    densities: the 16M hollow sphere deposited in the static box, the 1M
    one in the auto box (cell units), and a refinement level's difference
    spectra (32 / 0.75) on the 16M density. Each against the plain chain
    it replaced (F.pad, rfftn, the product with the stacked spectra,
    _irfftn_octant_batch) on the card within 1e-5 of the largest |a|, the
    interleaved layout, two solves bit for bit, pm_solve launches one a
    solve. Times with CUDA events, in turns: the plain chain against the
    solve, beside the bytes bound (pm_fft.solve_bytes). Then traced
    engines (the 1M auto box, the 16M persistent PM) count pm.solve.fused
    and pm_solve launches once a step. Callable alone after
    ``cuda_build.library()``. -> {"launches", "ms", "err"}."""
    import torch
    import torch.nn.functional as F

    from particle_sim_tpu_torch.core import generate as gen
    from particle_sim_tpu_torch.core.params import (
        PairwiseParams, PMConfig, SimParams,
    )
    from particle_sim_tpu_torch.core.state import ParticleState
    from particle_sim_tpu_torch.engine import Engine
    from particle_sim_tpu_torch.ops import pm, pm2, pm_cuda, pm_fft
    from particle_sim_tpu_torch.utils import trace

    t_start = time.perf_counter()
    g = 128
    bound = bytes_ms(pm_fft.solve_bytes(g))
    ms, errs, total = {}, {}, {}

    def plain_chain(rho, ks):
        rho_hat = torch.fft.rfftn(F.pad(rho, (0, g) * 3))
        return pm._irfftn_octant_batch(rho_hat[None] * ks, g)[0]

    for n, cfg in ((16_777_216, PMConfig()),
                   (1_000_000, PMConfig(auto_box=True))):
        pos_h, vel_h, col = gen.generate(n)
        st = ParticleState.from_arrays(pos_h, vel_h, col, device=dev)
        del pos_h, vel_h, col
        flat, na = st.pos.reshape(3, -1), st.n_active
        if cfg.auto_box:
            box, cell = pm.auto_box(flat, na, g)
            h = 1.0
        else:
            box, cell = pm_cuda.static_box(tuple(cfg.box_min),
                                           float(cfg.cell_size), dev)
            h = float(cfg.cell_size)
        rho = pm_cuda.deposit(flat, na, box, cell, g, periodic=False)
        box_name = "auto box" if cfg.auto_box else "static box"
        cases = [(f"n={n} {box_name}",
                  pm.base_kernels_device(cfg, cfg.softening, h, device=dev),
                  lambda r, c=cfg, h=h: pm.solve_accel(
                      r, c, c.softening, cell_size=h, fused=True))]
        if not cfg.auto_box:
            lv = pm2.PM2Config(None, 32.0, 0.75)
            h2 = lv.window_size / g
            cases.append((f"n={n} difference 32/0.75",
                          pm2.fine_kernels(cfg, lv, device=dev),
                          lambda r, h2=h2, lv=lv, c=cfg: pm.solve_accel_diff(
                              r, g, h2, lv.softening, c.softening,
                              fused=True)))
        for label, ks, run in cases:
            zero_launches()
            got = run(rho)
            again = run(rho)
            torch.cuda.synchronize()
            launched = launch_counts()["pm_solve"]
            want = plain_chain(rho, ks)
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            errs[label] = err
            if launched != 2:
                fail(f"phase 24 {label}: {launched} pm_solve launches for "
                     f"two solves")
            if pm_cuda.grid_layout(got, flat) != "interleaved":
                fail(f"phase 24 {label}: the solve's grids are not the "
                     f"interleaved view")
            if not torch.equal(got, again):
                fail(f"phase 24 {label}: two solves of one density differ")
            if not err <= 1e-5 * scale:
                fail(f"phase 24 {label}: {err:.3g} from the plain chain, "
                     f"bar {1e-5 * scale:.3g} (1e-5 of max|a| {scale:.4g})")
            t = median_ms([lambda: plain_chain(rho, ks), lambda: run(rho)],
                          reps=7, inner=10, lead_ms=10.0)
            ms[label] = t
            print(f"phase 24 {label} G={g}: the solve vs the plain chain "
                  f"max |d| {err:.3g} ({err / scale:.3g} of max|a| "
                  f"{scale:.4g}, bar 1e-5), two solves bit for bit, "
                  f"interleaved, {launched} launches; times (ms, in turns): "
                  f"plain chain {t[0]:.5f}, solve {t[1]:.5f}, bound "
                  f"{bound:.5f} ({pm_fft.solve_bytes(g) / 1e9:.3f} GB; "
                  f"{bound / t[1]:.1%} of it)")
        del st, flat, rho
        torch.cuda.empty_cache()

    # traced engines: pm.solve.fused once a step
    runs = (("pm1m autobox", dict(particle_count=1_000_000,
                                  pm=PMConfig(auto_box=True),
                                  pairwise=PairwiseParams(0.08, 2.0)),
             SimParams(delta_time=0.004)),
            ("pm16m persist", dict(particle_count=16_777_216, pm=PMConfig(),
                                   pm_persist=True,
                                   pairwise=PairwiseParams(1.0, 2.0)),
             SimParams()))
    for label, kw, params in runs:
        e = Engine(device=dev, **kw)
        e.step(params)
        torch.cuda.synchronize()
        zero_launches()
        trace.reset()
        trace.enable()
        try:
            for _ in range(10):
                e.step(params)
            recs = trace.records()
            counts = trace.counters()
        finally:
            trace.disable()
            trace.reset()
        got = launch_counts()
        if (counts.get("pm.solve.fused"), got["pm_solve"]) != (10, 10):
            fail(f"phase 24 {label}: pm.solve.fused "
                 f"{counts.get('pm.solve.fused')}, launches {got}")
        solve_ms = [r.device_ms for r in recs if r.name == "pm.solve"]
        print(f"phase 24 {label} engine x 10 traced: pm.solve.fused 10, "
              f"launches {got}; pm.solve {sum(solve_ms) / 10:.4f} device "
              f"ms a step")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        del e
        torch.cuda.empty_cache()
    print(f"phase 24 done in {time.perf_counter() - t_start:.1f} s")
    return {"launches": total, "ms": ms, "err": errs}


#: Phase 25: the grid sums kernel against its plain version (both float64
#: sums of the same float32 inputs, each rounded to float32, then divided),
#: in float32 ulps of grid_mean_scale: the sums' order moves them ~1e-10
#: relative, below one rounding of the sums, of the weight and of the mean.
GRID_SUMS_ULPS = 4
#: Phase 25: the grid mean against the particle mean, a share of
#: grid_mean_scale: rho's float32 rounding, largest past the collapse with
#: ~1.8M particles in one cell. Read on an H100 at the 16M persistent
#: states (three orientations, steps 0 / 40 / 150: at most 4.9e-10 /
#: 1.0e-6 / 1.0e-5) and the 1M auto box (8.7e-10); the bar is five times
#: the largest. Past the collapse the mean itself is of that order, so
#: this is a physics statement; GRID_SUMS_ULPS is what holds the kernel.
GRID_MEAN_SHARE = 5e-5


def grid_mean_scale(rho, grids):
    """f64[3]: sum rho |a| / sum rho + |sum rho a / sum rho| per component,
    the size the grid mean's bars are shares of."""
    w = rho.double().reshape(-1)
    a = grids.double().reshape(3, -1)
    c = w.sum()
    return ((a.abs() * w[None]).sum(1) + (a * w[None]).sum(1).abs()) / c


def turned(state, seed: int):
    """``state`` (core.state.ParticleState) with its positions turned about
    the origin by a rotation drawn from ``seed`` (a unit quaternion): the
    same sphere in another orientation against the PM grid."""
    import dataclasses

    import numpy as np
    import torch

    w, x, y, z = (lambda q: q / np.linalg.norm(q))(
        np.random.default_rng(seed).normal(size=4))
    rot = torch.tensor([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], dtype=torch.float64, device=state.pos.device)
    pos = (rot @ state.pos.reshape(3, -1).double()).float()
    return dataclasses.replace(state, pos=pos.view(state.pos.shape))


def phase25(dev) -> dict:
    """Phase 25: the single-level PM step's tail from the grids, two
    launches that never write the raw f32[3, N] field:
    pm_cuda.grid_momentum_mean (csrc/momentum.cu's grid instance: the
    mean from rho and the interleaved grid) and
    pm_cuda.gather_kick_and_step (csrc/pm.cu's kicked gather), against
    the tail it replaced (pm_cuda.gather, momentum_mean,
    clean_kick_and_step) on the main path's persistent 16M states
    (--pm-persist --central-mass 1000: the first frame, step 40, step
    150; masses and the live mask; the sphere as generated, timed, and
    turned by two seeded rotations) and the 1M hollow sphere in the auto
    box (a live count, the G / h^2 scale). Given the particle-side mean
    the kicked gather is pos and vel bit for bit the chain. The grid
    sums kernel is two launches bit for bit and within GRID_SUMS_ULPS
    float32 ulps of grid_mean_scale of grid_momentum_mean_plain, on the
    solved grids and on a random field of their shape (whose weighted
    mean stands far above that bar: a wrong weight, stride or component
    shows); the
    grid mean lies within GRID_MEAN_SHARE of grid_mean_scale of the
    particle side's. Times in turns (the old tail, the new, each launch
    alone) beside the bytes bounds, with dt 0 so repeated calls keep the
    state.
    Then traced engines count pm.kick_gathered once a step (1M per-frame
    static box and auto box, the 16M persistent from step 150) and never
    with a refinement level or the exact window. Callable alone after
    ``cuda_build.library()``. -> {"launches", "ms"}."""
    import numpy as np
    import torch

    from particle_sim_tpu_torch.core.params import (
        P_DT, PairwiseParams, PMConfig, SimParams,
    )
    from particle_sim_tpu_torch.engine import Engine
    from particle_sim_tpu_torch.ops import pm, pm2, pm_cuda, pmx
    from particle_sim_tpu_torch.ops import pm_persist as pper
    from particle_sim_tpu_torch.utils import trace

    t_start = time.perf_counter()
    pv = torch.from_numpy(SimParams(
        delta_time=0.016, is_mouse_dragging=True,
        mouse_position=(10.0, 5.0, -8.0), mouse_force=40.0,
        mouse_radius=30.0).pack()).to(dev)
    pv0 = pv.clone()
    pv0[P_DT] = 0.0                           # timing: the state stays
    ms, total = {}, {}

    u = 2.0 ** -24
    shares = []

    def tail_case(label, pos, vel, n_active, cfg, g_const, masses, live,
                  cell_sorted, timed=True):
        flat = pos.reshape(3, -1)
        n = flat.shape[1]
        rho, grids, box, cell, periodic = pm_cuda._mesh(
            flat, n_active, cfg, masses=masses, live=live, coll=None,
            plain=False, cell_sorted=cell_sorted)
        auto = cfg.auto_box
        gkw = dict(periodic=periodic, live=live)
        zero_launches()
        acc = pm_cuda.gather(grids, flat, n_active, box, cell, **gkw)
        p_mean = pm_cuda.momentum_mean(acc, n_active, masses=masses,
                                       live=live)
        g_mean = pm_cuda.grid_momentum_mean(rho, grids)
        again = pm_cuda.grid_momentum_mean(rho, grids)
        # the old tail and the kicked gather, from the same mean
        po, vo = pos.clone(), vel.clone()
        pm_cuda.clean_kick_and_step(po, vo, acc, pv, p_mean, n_active,
                                    g_const, live=live,
                                    cell=cell if auto else None)
        pk, vk = pos.clone(), vel.clone()
        pm_cuda.gather_kick_and_step(grids, pk, vk, pv, p_mean, n_active,
                                     g_const, box, cell, auto_box=auto,
                                     **gkw)
        torch.cuda.synchronize()
        got = launch_counts()
        if (got["pm_gather"], got["pm_momentum"], got["pm_kick_fused"],
                got["pm_kick_gather"], got["step"]) != (2, 3, 2, 1, 1):
            fail(f"phase 25 {label}: launches {got}")
        if not (torch.equal(pk, po) and torch.equal(vk, vo)):
            fail(f"phase 25 {label}: the kicked gather differs from the "
                 f"chain by {float((pk - po).abs().max()):.3g} / "
                 f"{float((vk - vo).abs().max()):.3g}")
        if not torch.equal(g_mean, again):
            fail(f"phase 25 {label}: two grid sums launches differ")
        # the kernel against its plain version: the solved grids and a
        # random field of their shape (its pad lane NaN), whose weighted
        # mean stands far above the bar
        buf = torch.randn((cfg.grid,) * 3 + (4,), generator=torch.Generator(
            device=dev).manual_seed(n + len(label)), device=dev)
        buf[..., 3] = float("nan")
        noise = pm.interleaved_view(buf)
        ulps = []
        for field in (grids, noise):
            k_mean = pm_cuda.grid_momentum_mean(rho, field).double()
            d = (k_mean - pm_cuda.grid_momentum_mean_plain(
                rho, field).double()).abs()
            ulps.append(d / (u * grid_mean_scale(rho, field)))
            if bool((ulps[-1] > GRID_SUMS_ULPS).any()):
                fail(f"phase 25 {label}: grid sums {k_mean.tolist()} off "
                     f"their plain version by {ulps[-1].tolist()} ulps "
                     f"(bar {GRID_SUMS_ULPS})")
        del noise, buf
        share = ((g_mean.double() - p_mean.double()).abs()
                 / grid_mean_scale(rho, grids))
        shares.append(float(share.max()))
        if bool((share > GRID_MEAN_SHARE).any()):
            fail(f"phase 25 {label}: grid mean {g_mean.tolist()} vs "
                 f"particle mean {p_mean.tolist()}: {share.tolist()} of "
                 f"the scale, over {GRID_MEAN_SHARE}")
        print(f"phase 25 {label}: kicked gather == gather + "
              f"clean_kick_and_step bit for bit (the particle mean); grid "
              f"sums == plain within {float(ulps[0].max()):.3g} / "
              f"{float(ulps[1].max()):.3g} ulps (solved / random field; bar "
              f"{GRID_SUMS_ULPS}), two launches equal; grid mean "
              f"{g_mean.tolist()} vs particle {p_mean.tolist()}, gap "
              f"{[f'{x:.3g}' for x in share.tolist()]} of the scale "
              f"{[f'{x:.4g}' for x in grid_mean_scale(rho, grids).tolist()]} "
              f"(bar {GRID_MEAN_SHARE})")
        if not timed:
            del acc, rho, grids
            return
        # times in turns, dt 0
        tp, tv = pos.clone(), vel.clone()
        kw_old = dict(live=live, cell=cell if auto else None)

        def old_tail():
            a = pm_cuda.gather(grids, tp.reshape(3, -1), n_active, box, cell,
                               **gkw)
            m = pm_cuda.momentum_mean(a, n_active, masses=masses, live=live)
            pm_cuda.clean_kick_and_step(tp, tv, a, pv0, m, n_active, g_const,
                                        **kw_old)

        fns = [
            old_tail,
            lambda: pm_cuda.gather_kick_and_step(
                grids, tp, tv, pv0, pm_cuda.grid_momentum_mean(rho, grids),
                n_active, g_const, box, cell, auto_box=auto, **gkw),
            lambda: pm_cuda.gather(grids, tp.reshape(3, -1), n_active, box,
                                   cell, **gkw),
            lambda: pm_cuda.momentum_mean(acc, n_active, masses=masses,
                                          live=live),
            lambda: pm_cuda.clean_kick_and_step(tp, tv, acc, pv0, p_mean,
                                                n_active, g_const, **kw_old),
            lambda: pm_cuda.grid_momentum_mean(rho, grids),
            lambda: pm_cuda.gather_kick_and_step(
                grids, tp, tv, pv0, p_mean, n_active, g_const, box, cell,
                auto_box=auto, **gkw)]
        t = median_ms(fns, reps=7, inner=10, lead_ms=4.0)
        live_b = 0 if live is None else 1
        mass_b = 0 if masses is None else 4
        grid_b = cfg.grid ** 3 * 16
        gather_b = n * (12 + live_b + 12) + grid_b
        sums_b = n * (12 + live_b + mass_b)
        kick_b = n * (12 + live_b + 48)
        gsums_b = cfg.grid ** 3 * 20
        kgather_b = n * (48 + live_b) + grid_b
        old_b, new_b = gather_b + sums_b + kick_b, gsums_b + kgather_b
        ms[label] = t
        print(f"phase 25 {label} times (ms, in turns, dt 0): old tail "
              f"{t[0]:.5f} (bound {bytes_ms(old_b):.5f}: "
              f"{old_b / 1e6:.1f} MB), new tail {t[1]:.5f} (bound "
              f"{bytes_ms(new_b):.5f}: {new_b / 1e6:.1f} MB), "
              f"{t[0] / t[1]:.2f}x; alone: gather {t[2]:.5f}, sums "
              f"{t[3]:.5f}, kicked step {t[4]:.5f}; grid sums {t[5]:.5f} "
              f"(bound {bytes_ms(gsums_b):.5f}), kicked gather {t[6]:.5f} "
              f"(bound {bytes_ms(kgather_b):.5f}: {kgather_b / 1e6:.1f} MB)")
        del acc, rho, grids

    # (1) the persistent 16M states of the main path's run: the sphere as
    # generated (timed; its engine is traced below) and in two seeded
    # orientations against the grid (checked)
    n16 = 16_777_216
    cfg = PMConfig()
    m16 = np.ones(n16, np.float32)
    m16[0] = 1000.0
    g16 = torch.tensor([1.0], device=dev)[0]
    # a device count: a Python int would be uploaded at every call
    na16 = torch.tensor(n16, dtype=torch.int32, device=dev)
    e16 = None
    for turn in (None, 2_147_483_675, 26):
        e = Engine(n16, device=dev, pm=cfg, pm_persist=True,
                   pairwise=PairwiseParams(1.0, cfg.softening))
        if turn is not None:
            e.state = turned(e.state, turn)
        e.set_masses(m16)
        name = "persistent 16M" + ("" if turn is None else f" turn {turn}")
        done = 0
        for label in ("step 0", "step 40", "step 150"):
            if label == "step 0":
                st = pper.init_sorted(e.state.pos.reshape(3, -1), n16, cfg,
                                      masses=e._masses_for_capacity())
                vel = torch.randn(st.pos.shape, generator=torch.Generator(
                    device=dev).manual_seed(25), device=dev)
            else:
                while done < int(label.split()[1]):
                    e.step(SimParams())
                    done += 1
                torch.cuda.synchronize()
                st = e._persist
                vel = st.vel
            tail_case(f"{name} {label}", st.pos.view(3, -1, 128),
                      vel.reshape(3, -1, 128), na16, cfg, g16, st.masses,
                      st.ids < n16, True, timed=turn is None)
        del st, vel
        if turn is None:
            e16 = e
        del e
        torch.cuda.empty_cache()

    # (2) the 1M hollow sphere in the auto box (a live count)
    n1 = 1_000_000
    cfg_a = PMConfig(auto_box=True)
    e1 = Engine(n1, device=dev, pm=cfg_a, pm_persist=False,
                pairwise=PairwiseParams(0.08, cfg_a.softening))
    s1 = e1.state
    tail_case("auto box 1M", s1.pos, torch.randn(
        s1.pos.shape, generator=torch.Generator(device=dev).manual_seed(26),
        device=dev), s1.n_active, cfg_a, torch.tensor([0.08], device=dev)[0],
        None, None, False)
    del e1, s1

    # (3) traced engines: pm.kick_gathered once a step on one interleaved
    # grid, never with levels or the exact window
    p1 = dict(particle_count=n1, pm_persist=False,
              pairwise=PairwiseParams(0.08, 2.0))
    runs = (("pm1m static", dict(p1, pm=cfg), 10),
            ("pm1m autobox", dict(p1, pm=cfg_a), 10),
            ("pm16m persist", None, 10),
            ("pm1m two-level", dict(p1, pm=cfg, pm2=pm2.PM2Config(
                None, 32.0, 0.75)), 0),
            ("pm1m pmx", dict(p1, pm=cfg, pmx=pmx.PMXConfig(
                window_size=4.0, softening=0.1, capacity=8192)), 0))
    for label, kw, want in runs:
        e = e16 if kw is None else Engine(device=dev, **kw)
        e.step(SimParams(delta_time=0.004))
        torch.cuda.synchronize()
        zero_launches()
        trace.reset()
        trace.enable()
        try:
            for _ in range(10):
                e.step(SimParams(delta_time=0.004))
            recs = trace.records()
            counts = trace.counters()
        finally:
            trace.disable()
            trace.reset()
        got = launch_counts()
        steps = sum(1 for r in recs if r.name == "engine.step")
        if (steps, counts.get("pm.kick_gathered", 0), got["pm_kick_gather"],
                counts.get("pm.kick_fused"), got["pm_kick_fused"],
                got["pm_momentum"]) != (10, want, want, 10, 10, 10):
            fail(f"phase 25 {label}: engine.step {steps}, pm.kick_gathered "
                 f"{counts.get('pm.kick_gathered')}, pm.kick_fused "
                 f"{counts.get('pm.kick_fused')}, launches {got}")
        tail = [r.device_ms for r in recs
                if r.name in ("pm.momentum", "pm.kick")]
        print(f"phase 25 {label} engine x 10 traced: pm.kick_gathered "
              f"{want}, pm.kick_fused 10, launches {got}; pm.momentum + "
              f"pm.kick {sum(tail) / 10:.4f} device ms a step")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        del e
        torch.cuda.empty_cache()
    del e16
    torch.cuda.empty_cache()
    print(f"phase 25 done in {time.perf_counter() - t_start:.1f} s; the "
          f"grid mean's largest gap {max(shares):.3g} of the scale (bar "
          f"{GRID_MEAN_SHARE})")
    return {"launches": total, "ms": ms, "share": shares}


#: Float32 ulps (of |origin| + the window) an origin of the window pass may
#: lie from the plain one beyond the float32 sums' own rounding bar: the
#: division and the subtraction round once each, the sums twice.
ORIGIN_ULPS = 4


def window_pass_bytes(plan, n: int, masses: bool, masks: bool) -> int:
    """Bytes one window pass must move over ``n`` slots (pm2._plan's
    launches): a launch that tests or reduces reads each slot's position
    (12 B), live flag (1 B) and mass (4 B, with masses), and writes its
    mask (1 B) when it tests a window with ``masks``; a launch that only
    finishes an origin moves nothing a slot."""
    total = 0
    for ln in plan:
        mask = masks and ln.win >= 0
        if mask or ln.sums:
            total += n * (13 + 4 * masses + mask)
    return total


def phase26(dev) -> dict:
    """Phase 26: the refinement windows' bookkeeping in one pass a window
    (pm2.window_pass -> csrc/windows.cu: each launch finishes a window's
    origin from the sums the launch before it reduced, writes the mask
    and reduces its members' sums) against the plain bookkeeping it
    replaced on the step (pm2._nested_wmins, a mask a level, then
    pmx.window_origin, which takes the levels' origins again, the member
    mask and its count), on two deep-zoom states: the example's --exact
    scene at 500,000 (capacity 147,456) after 100 steps (two tracked
    levels and the exact window), and at 16M a core (sigma 1), a cluster
    (sigma 4) and a halo (sigma 15) off the origin, with masses, under
    the 32 / 0.6 and 8 / 0.2 levels and the 2-unit exact window, every
    window holding members (the 16M sphere of the deep_zoom16m cell
    empties its windows within 40 steps, so it would compare
    nothing). Two calls give the same bits; each mask is
    _in_window at the kernel's own origin bit for bit; the origins lie
    within ORIGIN_ULPS float32 ulps of the plain ones or on the
    float32-sum bar; masks differ from the plain ones only within 1e-5
    of a face; the member count is the mask's. Times in turns (the plain
    chain, the pass; the verdict's origins alone, plain and pass) beside
    the bytes bound (window_pass_bytes at 3.35 TB/s). Callable alone
    after ``cuda_build.library()``. -> {"launches", "ms"}."""
    import dataclasses

    import torch

    from particle_sim_tpu_torch.examples import deep_zoom
    from particle_sim_tpu_torch.ops import pm2, pmx

    t_start = time.perf_counter()
    u = 2.0 ** -24
    out_ms = {}

    def exact_state():
        e, params, _ = deep_zoom.build(deep_zoom.build_parser().parse_args(
            ["--count", "500000", "--exact", "--device", "cuda"]))
        e.set_pmx(dataclasses.replace(e.pmx, capacity=147_456))
        return e, params, 100

    def exact_scene():
        e, params, steps = exact_state()
        for _ in range(steps):
            e.step(params)
        torch.cuda.synchronize()
        st = e._persist
        return (st.pos, st.ids < e.state.n_active, st.masses,
                pm2.as_levels(e.pm2), e.pmx)

    def halo_scene(n=16_777_216):
        g = torch.Generator(dev).manual_seed(31)
        pos = torch.randn((3, n), device=dev, generator=g)
        pos[:, n // 4: n // 2] *= 4.0
        pos[:, n // 2:] *= 15.0
        pos += torch.tensor([1.5, -0.5, 0.7], device=dev)[:, None]
        masses = 0.5 + torch.rand(n, device=dev, generator=g)
        live = torch.arange(n, device=dev) < n - 4096
        return (pos, live, masses,
                (pm2.PM2Config(None, 32.0, 0.6),
                 pm2.PM2Config(None, 8.0, 0.2)),
                pmx.PMXConfig(2.0, 0.05, capacity=262_144))

    def plain_pass(pos, live, levels, masses, cfgx):
        """The plain bookkeeping the step ran before the pass."""
        w = pm2.window_pass(pos, live, levels, masses=masses, plain=True)
        wx = pmx.window_origin(pos, live, cfgx, levels, masses=masses)
        xm = pmx._member_mask(pos, wx, cfgx, live)
        return w._replace(x_origin=wx, x_member=xm,
                          x_count=xm.sum(dtype=torch.int32))

    launched = 0
    for label, make in (("exact core n=500000", exact_scene),
                        ("deep zoom n=16777216", halo_scene)):
        pos, live, masses, levels, cfgx = make()
        wins = levels + (cfgx,)
        exact = pm2.Win.of(cfgx)
        before = pm2.WINDOW_LAUNCHES
        win = pm2.window_pass(pos, live, levels, masses=masses, exact=exact)
        again = pm2.window_pass(pos, live, levels, masses=masses,
                                exact=exact)
        plain = plain_pass(pos, live, levels, masses, cfgx)
        torch.cuda.synchronize()
        plan = pm2._plan(tuple(pm2.Win.of(c) for c in wins), True)
        launched += pm2.WINDOW_LAUNCHES - before
        if pm2.WINDOW_LAUNCHES - before != 2 * len(plan):
            fail(f"phase 26 {label}: {pm2.WINDOW_LAUNCHES - before} "
                 f"launches for two passes of {len(plan)}")
        got_o = list(win.origins) + [win.x_origin]
        got_m = list(win.masks) + [win.x_member]
        want_o = list(plain.origins) + [plain.x_origin]
        want_m = list(plain.masks) + [plain.x_member]
        for a, b in zip(got_o + got_m,
                        list(again.origins) + [again.x_origin]
                        + list(again.masks) + [again.x_member]):
            if not torch.equal(a, b):
                fail(f"phase 26 {label}: two passes differ")
        parent, gaps, differ, members = live, [], [], []
        for k, c in enumerate(wins):
            if not torch.equal(got_m[k], pm2._in_window(
                    pos, got_o[k], c.window_size, c.margin) & live):
                fail(f"phase 26 {label}: window {k}'s mask is not "
                     f"_in_window at its origin")
            o, w_o = got_o[k].double(), want_o[k].double()
            ulp_o = (torch.nextafter(w_o.abs().float() + c.window_size,
                                     torch.tensor(1e30, device=dev))
                     - (w_o.abs().float() + c.window_size)).double()
            w = parent.double() * (1.0 if masses is None
                                   else masses.double())
            tot = float(w.sum())
            scale = ((pos.double().abs() * w[None]).sum(1) / tot
                     if tot > 0 else torch.zeros(3, device=dev,
                                                 dtype=torch.float64))
            k_bar = math.ceil(math.log2(max(int(parent.sum()), 2))) + 4
            bar = ORIGIN_ULPS * ulp_o + k_bar * u * scale
            gap = (o - w_o).abs()
            if not bool((gap <= bar).all()):
                fail(f"phase 26 {label}: window {k}'s origin {o.tolist()} "
                     f"is {gap.tolist()} from the plain one (bar "
                     f"{bar.tolist()})")
            gaps.append(float((gap / ulp_o).max()))
            d = got_m[k] != want_m[k]
            if bool(d.any()):
                p = pos[:, d].double()
                near = torch.zeros(p.shape[1], dtype=torch.bool, device=dev)
                tol = max(1e-5, 2 * float(gap.max()))
                for oo in (o, w_o):
                    lo = oo[:, None] + c.margin
                    hi = lo + (c.window_size - 2.0 * c.margin)
                    near |= (((p - lo).abs() < tol)
                             | ((p - hi).abs() < tol)).any(0)
                if not bool(near.all()):
                    fail(f"phase 26 {label}: window {k}'s mask differs "
                         f"from the plain one away from its faces")
            differ.append(int(d.sum()))
            members.append(int(got_m[k].sum()))
            parent = got_m[k]
        if int(win.x_count) != members[-1] or min(members) == 0:
            fail(f"phase 26 {label}: count {int(win.x_count)} for "
                 f"{members[-1]} members, members {members}")
        n = pos.shape[1]
        ms = median_ms([
            lambda: plain_pass(pos, live, levels, masses, cfgx),
            lambda: pm2.window_pass(pos, live, levels, masses=masses,
                                    exact=exact),
            lambda: pm2._nested_wmins(pos, live, None, levels, masses),
            lambda: pm2.window_pass(pos, live, levels, masses=masses,
                                    masks=False)], lead_ms=5.0)
        v_plan = pm2._plan(tuple(pm2.Win.of(c) for c in levels), False)
        bound = bytes_ms(window_pass_bytes(plan, n, masses is not None,
                                           True))
        v_bound = bytes_ms(window_pass_bytes(v_plan, n, masses is not None,
                                             False))
        out_ms[label] = {"plain": ms[0], "pass": ms[1], "bound": bound,
                         "verdict_plain": ms[2], "verdict_pass": ms[3],
                         "verdict_bound": v_bound}
        print(f"phase 26 {label}: {len(plan)} launches a step (members "
              f"{members}, masses {masses is not None}); the pass "
              f"{ms[1]:.4f} ms against the plain bookkeeping {ms[0]:.4f} "
              f"(bound {bound:.4f} ms, {100 * bound / ms[1]:.1f} % of it; "
              f"{window_pass_bytes(plan, n, masses is not None, True) / n:.0f}"
              f" B a slot over {len(plan)} launches); the verdict's "
              f"origins {ms[3]:.4f} against {ms[2]:.4f} (bound "
              f"{v_bound:.4f}); origins within {max(gaps):.2f} ulps of "
              f"the plain ones, masks differ at {differ} slots (near a "
              f"face); two passes bit for bit")
        del pos, live, masses, win, again, plain
        torch.cuda.empty_cache()
    print(f"phase 26 done in {time.perf_counter() - t_start:.1f} s")
    return {"launches": {"window_pass": launched}, "ms": out_ms}


def phase20(dev, states) -> dict:
    """Phase 20: the mesh path (particle_sim_tpu_torch/parallel/) at world
    size 1 under NCCL, at full width: the process group starts here with
    a file:// store under build/ and is destroyed at the end. Each path
    runs ``Engine(mesh=make_mesh())`` beside ``Engine()`` from the same
    state; the launch counts are the mesh engines' drives only. ``states``:
    phase 2's ParticleStates. -> {"launches": summed counts, "ms": the
    mesh and single-device step times, "gaps": the measured gaps}."""
    import numpy as np
    import torch

    from particle_sim_tpu_torch.core.params import (
        PairwiseParams, PMConfig, SimParams,
    )
    from particle_sim_tpu_torch.core.state import ParticleState
    from particle_sim_tpu_torch.engine import Engine
    from particle_sim_tpu_torch.ops import pm2, pmx
    from particle_sim_tpu_torch.parallel import distributed, mesh as ml
    from particle_sim_tpu_torch.render import raster, raster_compact as rc
    from particle_sim_tpu_torch.render.camera import Camera

    t_start = time.perf_counter()
    store = os.path.join(ROOT, "build", f"phase20_store_{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    distributed.initialize(f"file://{store}", 1, 0, device="cuda",
                           timeout_s=120)
    if torch.distributed.get_backend() != "nccl":
        fail(f"phase 20: backend {torch.distributed.get_backend()}")
    mesh = ml.make_mesh("cuda")
    total = {}
    ms, gaps = {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def clone_state(st):
        return ParticleState(pos=st.pos.clone(), vel=st.vel.clone(),
                             init_color=st.init_color.clone(),
                             n_active=st.n_active.clone())

    def drive(name, kw, params, steps, start=None, expect=None):
        """(single, mesh) engines after ``steps`` steps from the same
        state; the mesh engine's launches counted (and held to
        ``expect``, a dict of exact counts)."""
        one = Engine(device=dev, **kw)
        two = Engine(device=dev, mesh=mesh, **kw)
        if start is not None:
            one.state = clone_state(start)
            two.state = clone_state(start)
        for _ in range(steps):
            one.step(params)
        torch.cuda.synchronize()
        zero_launches()
        for _ in range(steps):
            two.step(params)
        torch.cuda.synchronize()
        got = launch_counts()
        add(got)
        if expect and any(got[k] != v for k, v in expect.items()):
            fail(f"phase 20 {name}: launches {got}, expected {expect}")
        return one, two, got

    def timed(name, one, two, params, lead=0.0):
        t = median_ms([lambda: one.step(params), lambda: two.step(params)],
                      reps=5, inner=5, lead_ms=lead)
        ms[name] = t
        return t

    def gap(a, b):
        return float((a - b).abs().max())

    orbit = SimParams(is_mouse_dragging=True, mouse_position=(20.0, 5.0, 30.0),
                      mouse_force=60.0, mouse_radius=30.0, gravity=0.5,
                      color_mode=1)
    n16 = 16_777_216

    # (a) the attractor, dp: 16M x 100 steps, bit for bit
    one, two, got = drive("dp", dict(particle_count=n16), orbit, 100,
                          start=states[n16], expect={"step": 100})
    sa, sb = one.state, two.state
    if not (torch.equal(sa.pos, sb.pos) and torch.equal(sa.vel, sb.vel)):
        fail(f"phase 20 dp: mesh vs single differ by {gap(sa.pos, sb.pos)}")
    t = timed("dp 16M", one, two, orbit, lead=2.0)
    print(f"phase 20 (a) dp {n16} x 100: mesh == single bit for bit, "
          f"launches {got}; a step {t[1]:.5f} ms on the mesh, {t[0]:.5f} "
          f"without")
    del one, two, sa, sb

    # (b) the direct ring with masses: 65,536 x 20, JAX's 1e-4
    n_g = 65_536
    masses = np.ones(n_g, np.float32)
    masses[0] = 1000.0
    one, two, got = drive(
        "ring", dict(particle_count=n_g, pairwise=PairwiseParams(1.0, 0.5),
                     masses=masses), SimParams(), 20,
        expect={"pairwise": 20, "step": 20})
    pa, pb = one.state.pos, two.state.pos
    g_ring = gap(pa, pb)
    if not torch.allclose(pb, pa, rtol=1e-4, atol=1e-4):
        fail(f"phase 20 ring: mesh vs single {g_ring:.3g} (bar 1e-4)")
    gaps["ring"] = g_ring
    t = timed("ring 65536", one, two, SimParams())
    print(f"phase 20 (b) ring {n_g} x 20 with masses: mesh vs single max "
          f"|dp| {g_ring:.3g} (bar 1e-4), launches {got}; a step "
          f"{t[1]:.4f} ms on the mesh, {t[0]:.4f} without")
    del one, two

    # (c) pm_dp: 1M, G = 128, static box, 20 steps
    n1 = 1_000_000
    cfg = PMConfig()
    one, two, got = drive(
        "pm_dp", dict(particle_count=n1, pm=cfg, pm_persist=False,
                      pairwise=PairwiseParams(0.05, cfg.softening)),
        SimParams(), 20, start=states[n1],
        expect={"pm_deposit": 20, "pm_gather": 20, "step": 20})
    pa, pb = one.state.pos, two.state.pos
    g_pm = gap(pa, pb)
    if not torch.allclose(pb, pa, rtol=1e-4, atol=1e-4):
        fail(f"phase 20 pm_dp: mesh vs single {g_pm:.3g} (bar 1e-4)")
    gaps["pm_dp"] = g_pm
    t = timed("pm_dp 1M", one, two, SimParams(), lead=5.0)
    tw = timed("pm_dp 1M wall", one, two, SimParams())
    print(f"phase 20 (c) pm_dp {n1} x 20 (G = 128, static box): mesh vs "
          f"single max |dp| {g_pm:.3g} (bar 1e-4), launches {got}; a step "
          f"{t[1]:.4f} ms on the mesh (the 8 MB grid all-reduce), "
          f"{t[0]:.4f} without (queued behind a spin); {tw[1]:.4f} and "
          f"{tw[0]:.4f} with the host's own pace")
    del one, two

    # (d) the persistent PM on the mesh: the 16M hollow sphere, 20 frames
    # (G 0.01: the shell falls a few cells), JAX's persistent-dp bars
    pp16 = dict(particle_count=n16, pm=cfg, pm_persist=True,
                pairwise=PairwiseParams(0.01, cfg.softening))
    frame = SimParams(color_mode=0)
    one, two, got = drive("persist", pp16, frame, 20,
                          expect={"pm_deposit": 20, "pm_gather": 20,
                                  "step": 20})
    sa, sb = one.state, two.state
    dpos, dvel = gap(sa.pos, sb.pos), gap(sa.vel, sb.vel)
    vbar = max(0.02 * float(sa.vel.abs().max()), 2e-3)
    if dpos > 1e-2 or dvel > vbar:
        fail(f"phase 20 persistent: mesh vs single |dp| {dpos:.3g} (bar "
             f"1e-2), |dv| {dvel:.3g} (bar {vbar:.3g})")
    gaps["persist"] = (dpos, dvel)
    print(f"phase 20 (d) persistent pm {n16} x 20: mesh vs single max |dp| "
          f"{dpos:.3g} (bar 1e-2), |dv| {dvel:.3g} (bar {vbar:.3g}), "
          f"repairs {two.resorts} / {one.resorts}, launches {got}")

    # (f) render_dp at 16M @ 1920x1080 from the persistent carry: bit for
    # bit the single-device compact frame of the same carry
    cam = Camera(aspect=16 / 9)
    for e in (one, two):                  # both frames from a live carry
        e.step(frame)
    zero_launches()
    img = two.render_frame_device(cam, frame, width=1920, height=1080)
    torch.cuda.synchronize()
    got_r = launch_counts()
    add(got_r)
    if not two._identity_dirty or got_r["compact"] != 1 \
            or got_r["deposit"] != 1:
        fail(f"phase 20 render_dp: not from the carry, launches {got_r}")
    c = two._persist
    planes = (3, -1, 128)
    fb1 = rc.render(c.pos.view(planes), c.vel.view(planes),
                    raster.unpack_col24(c.col24).view(planes),
                    two._param_vec(frame),
                    torch.from_numpy(cam.view_proj()).to(dev),
                    two._state.n_active, width=1920, height=1080)
    if not torch.equal(img, raster.to_rgba8(fb1)):
        fail("phase 20 render_dp: the mesh frame differs from the "
             "single-device frame of the same carry")
    lit = int((img[..., :3].amax(-1) > 0).sum())

    def render_one():
        one.render_frame_device(cam, frame, width=1920, height=1080)

    def render_two():
        two.render_frame_device(cam, frame, width=1920, height=1080)

    t = median_ms([render_one, render_two], reps=5, inner=3)
    if not one._identity_dirty:
        fail("phase 20 render: the single-device frame rebuilt the identity")
    ms["render_dp 16M"] = t
    print(f"phase 20 (f) render_dp {n16} @ 1920x1080 from the persistent "
          f"carry: == the single-device frame bit for bit, {lit} lit "
          f"pixels, launches {got_r}; a frame {t[1]:.4f} ms on the mesh "
          f"(the 24 MB tile all-reduce), {t[0]:.4f} without")
    still = SimParams(delta_time=0.0, color_mode=0)
    t = timed("persist 16M", one, two, still, lead=5.0)
    print(f"phase 20 (d) persistent step {n16} (dt = 0): {t[1]:.4f} ms on "
          f"the mesh, {t[0]:.4f} without")
    del one, two, sa, sb, c, img, fb1

    # (e) the deep-zoom composition (phase 19's scene) at 1M: pm2 32 / 0.6
    # + 8 / 0.2 and pmx 2 / 0.05, one frame, JAX's persistent-dp bars
    rng = np.random.default_rng(13)

    def ball(k, radius, off):
        d = rng.normal(size=(k, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        r = radius * rng.random(k).astype(np.float32) ** (1 / 3)
        return d * r[:, None] + off

    center = np.float32([14.0, 6.0, -4.0])
    zpos = np.concatenate([ball(n1 // 4, 0.8, center),
                           ball(n1 // 4, 4.0, center),
                           ball(n1 - n1 // 2, 40.0, 0.0)])
    zkw = dict(particle_count=n1, pm=PMConfig(softening=3.0),
               pairwise=PairwiseParams(0.05, 3.0),
               pm2=(pm2.PM2Config(window_min=None, window_size=32.0,
                                  softening=0.6),
                    pm2.PM2Config(window_min=None, window_size=8.0,
                                  softening=0.2)),
               pmx=pmx.PMXConfig(window_size=2.0, softening=0.05,
                                 capacity=262144), pm_persist=True)
    zstart = ParticleState.from_arrays(zpos, np.zeros_like(zpos),
                                       np.full_like(zpos, 0.7), device=dev)
    zp = SimParams(delta_time=0.016, gravity=0.0)
    one, two, got = drive("deep zoom", zkw, zp, 1, start=zstart,
                          expect={"pm_deposit": 3, "pm_gather": 3,
                                  "pairwise": 0, "pairwise_diff": 1,
                                  "step": 1})
    m1, m2 = one.pmx_member_count(), two.pmx_member_count()
    sa, sb = one.state, two.state
    dpos, dvel = gap(sa.pos, sb.pos), gap(sa.vel, sb.vel)
    vbar = max(0.02 * float(sa.vel.abs().max()), 2e-3)
    if m1 != m2 or dpos > 1e-2 or dvel > vbar:
        fail(f"phase 20 deep zoom: members {m2} / {m1}, |dp| {dpos:.3g} "
             f"(bar 1e-2), |dv| {dvel:.3g} (bar {vbar:.3g})")
    gaps["deep zoom"] = (dpos, dvel)
    t = timed("deep zoom 1M", one, two, SimParams(delta_time=0.0))
    print(f"phase 20 (e) deep zoom {n1} x 1 (pm2 32 / 0.6, 8 / 0.2, pmx 2 /"
          f" 0.05): members (members, corrected) {m2} on the mesh, {m1} "
          f"without; max |dp| {dpos:.3g} (bar 1e-2), |dv| {dvel:.3g} (bar "
          f"{vbar:.3g}), launches {got}; a step (dt = 0) {t[1]:.4f} ms on "
          f"the mesh, {t[0]:.4f} without")
    del one, two, sa, sb

    # the collectives alone at world size 1: an all-reduce of the 8 MB
    # PM grid (G = 128) and of the 24 MB tile planes of a 1920x1080 frame,
    # device time beside a device copy of the same bytes, and the host's
    # time to enqueue one
    coll = ml.Collectives(mesh)
    for label, shape in (("grid G=128", (128, 128, 128)),
                         ("tiles 1920x1080", (2025, 3, 8, 128))):
        buf = torch.ones(shape, device=dev)
        dst = torch.empty_like(buf)
        t = median_ms([lambda: coll.sum_(buf), lambda: dst.copy_(buf)],
                      reps=5, inner=10, lead_ms=3.0)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(50):
            coll.sum_(buf)
        host_us = (time.perf_counter() - h0) / 50 * 1e6
        # behind 20 ms of queued device work: a call that waited for the
        # device would take that long
        torch.cuda.synchronize()
        torch.cuda._sleep(int(20 * 2e6))
        h0 = time.perf_counter()
        coll.sum_(buf)
        behind_ms = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
        mb = buf.numel() * 4 / 1e6
        ms[f"all_reduce {label}"] = t + [host_us, behind_ms]
        print(f"phase 20 all_reduce {label} ({mb:.1f} MB, nccl "
              f"{torch.cuda.nccl.version()}): "
              f"{t[0]:.5f} ms on the device ({mb / t[0]:.1f} GB/s) | a "
              f"device copy of the same bytes {t[1]:.5f} ms | "
              f"{host_us:.1f} us to enqueue on the host, {behind_ms:.3f} ms "
              f"behind a 20 ms spin")
    distributed.shutdown()
    os.remove(store)

    phase20_cli()
    print(f"phase 20 done in {time.perf_counter() - t_start:.1f} s: "
          f"launches {total}")
    return {"launches": total, "ms": ms, "gaps": gaps}


def phase20_cli() -> None:
    """Phase 20's CLI drive, over every visible GPU (also callable alone):
    the attractor at 1M x 100 (a dragged orbit, a frame every 50 steps, a
    checkpoint at the end) without a mesh, then with --mesh auto under
    torchrun (one rank a visible GPU) and without it (one GPU: a world of
    one in its process; more: one spawned rank a GPU). The mesh runs'
    checkpoints equal the single run's bit for bit (the attractor sums
    nothing across particles), their frames are within one u8 level (the
    tile sums add the ranks' planes in another order). Then the
    persistent PM with a central mass under torchrun."""
    import numpy as np
    import torch

    n_gpu = torch.cuda.device_count()
    cli = [sys.executable, "-m", "particle_sim_tpu_torch.app.cli",
           "--device", "cuda"]
    torchrun = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc_per_node", str(n_gpu), *cli[1:]]
    attractor = ["--count", "1000000", "--steps", "100", "--drag",
                 "--orbit-mouse", "--color-mode", "1", "--render-every",
                 "50", "--checkpoint-every", "100", "--stats-every", "50"]
    runs = (("single", cli + attractor),
            ("torchrun", torchrun + ["--mesh", "auto", *attractor]),
            ("no torchrun", cli + ["--mesh", "auto", *attractor]),
            ("torchrun persistent", torchrun + [
                "--mesh", "auto", "--count", "1000000", "--steps", "100",
                "--pm", "--pm-persist", "--central-mass", "1000",
                "--stats-every", "50"]))
    outs = {}
    for how, cmd in runs:
        d = os.path.join(ROOT, "build", "phase20_cli", how.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        ck = os.path.join(d, "checkpoint.npz")
        t0 = time.perf_counter()
        res = subprocess.run(cmd + ["--render-dir", d, "--checkpoint", ck],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        wall = time.perf_counter() - t0
        lines = res.stdout.strip().splitlines()
        done = json.loads(lines[-1]) if lines else {}
        line = f"mesh: dp over {n_gpu} devices"
        if (res.returncode != 0 or not done.get("done")
                or (how != "single") != (line in res.stderr)):
            fail(f"phase 20 cli ({how}): rc {res.returncode}\n"
                 f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        note = "" if how == "single" else f"'{line}', "
        if "persistent" not in how:
            with np.load(ck) as z:
                pos = z["positions"]
            frames = [read_png(os.path.join(d, f"frame_{k:06d}.png"))
                      for k in (50, 100)]
            outs[how] = (pos, frames)
            p1, f1 = outs["single"]
            du8 = max(int(np.abs(a.astype(int) - b.astype(int)).max())
                      for a, b in zip(frames, f1))
            if not np.array_equal(pos, p1) or du8 > 1:
                fail(f"phase 20 cli ({how}): the final state or a frame "
                     f"differs from the single-device run (u8 {du8})")
            if how != "single":
                note += (f"the checkpoint == the single run's bit for bit, "
                         f"frames within {du8} u8, ")
        print(f"phase 20 cli ({how}): {note}{done['steps']} steps in "
              f"{done['wall_s']} s ({done['particle_steps_per_sec']:.4g} "
              f"particle-steps/s), {wall:.1f} s with start-up")


def phase21(dev) -> dict:
    """Phase 21: the packaging tool (app/release.py) with --web --native
    --warm --aot (exported for the card) into a directory under build/:
    every MANIFEST sha256 matches its file, the warmed kernel library
    loads and its step kernel matches the plain step, and an exported
    step loads and matches step_ref on the card."""
    import shutil
    import tempfile

    import torch

    from particle_sim_tpu_torch.app import release
    from particle_sim_tpu_torch.ops import step_ref
    from particle_sim_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = tempfile.mkdtemp(prefix="phase21_", dir=os.path.join(ROOT, "build"))
    counts = [65_536, 1_000_000]
    with contextlib.redirect_stdout(io.StringIO()):
        rc_ = release.main(["--out", out, "--web", "--native", "--warm",
                            "--aot", "--counts", *map(str, counts)])
    if rc_ != 0:
        fail(f"phase 21: release exited {rc_}")
    manifest = json.load(open(os.path.join(out, "MANIFEST.json")))
    arts = manifest["artifacts"]
    for rel, digest in arts.items():
        if release.sha256(os.path.join(out, rel)) != digest:
            fail(f"phase 21: {rel} does not match its MANIFEST sha256")
    libs = [rel for rel in arts if rel.startswith("torch-kernels/")]
    if len(libs) != 1 or len(arts) != 8 + 1 + 1 + len(counts):
        fail(f"phase 21: artifacts {sorted(arts)}")
    lib = cuda_build.load(os.path.join(out, libs[0]))
    pos, vel, pv = release.step_example(1_000_000, dev)
    pk, vk = pos.clone(), vel.clone()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(lib.psim_step(pk.data_ptr(), vk.data_ptr(),
                                   pv.data_ptr(), pos.numel() // 3, 1,
                                   stream), "warmed step")
    want = step_ref.step(pos, vel, pv)
    e_lib = max(check_close("phase 21 warmed step kernel", a, b, 1e-6, 1e-6)
                for a, b in zip((pk, vk), want))
    e_aot = []
    for n in counts:
        args = release.step_example(n, dev)
        ep = torch.export.load(os.path.join(out, "aot",
                                            f"step_torch_n{n}.pt2"))
        got = ep.module()(*args)
        ref = step_ref.step(*args)
        e_aot.append(max(float((a - b).abs().max())
                         for a, b in zip(got, ref)))
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"phase 21: the exported step at {n} differs from step_ref "
                 f"on the card by {e_aot[-1]:.3g}")
    print(f"phase 21 release --web --native --warm --aot: {len(arts)} "
          f"artifacts, every sha256 matches; the warmed library "
          f"{os.path.basename(libs[0])} loads and its step kernel matches "
          f"step_ref within {e_lib:.3g} at 1M; the exported step at "
          f"{counts} == step_ref on the card ({time.perf_counter() - t0:.1f}"
          f" s)")
    shutil.rmtree(out)
    return {"max_err": e_lib}


def check_finite_line(line: str) -> None:
    """Raise unless a printed line holds numbers and every one is finite:
    a JSON object's values (nested lists too), else the numbers of the
    text."""
    import math
    import re

    if line.startswith("{"):
        nums, todo = [], list(json.loads(line).values())
        while todo:
            v = todo.pop()
            if isinstance(v, list):
                todo.extend(v)
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                nums.append(float(v))
    else:
        nums = [float(t) for t in re.findall(
            r"[-+]?(?:nan|inf|\d+\.?\d*(?:e[-+]?\d+)?)", line)]
    if not nums or not all(math.isfinite(v) for v in nums):
        fail(f"a printed line is not finite: {line!r}")


def phase22(dev) -> dict:
    """Phase 22: the port's worked examples (particle_sim_tpu_torch/
    examples/) through their main(argv) on the card, at the JAX scripts'
    documented sizes, then each example's first frame at 65,536 on the
    kernel path against the plain path (Method.TORCH) on the card.
    -> {"launches": the six runs' launch counts, summed}."""
    import dataclasses
    import logging

    import torch

    from particle_sim_tpu_torch.core.params import Method
    from particle_sim_tpu_torch.examples import (
        attractor, cluster_core, collapse, deep_zoom, disk,
    )
    from particle_sim_tpu_torch.ops import pm2, pm_cuda, pmx
    from particle_sim_tpu_torch.render import raster
    from particle_sim_tpu_torch.render import raster_compact as rc

    t_start = time.perf_counter()
    frame_k = ("compact", "deposit")
    # (label, module, extra arguments, steps, steps a line, frames, the
    # kernels the run must launch); every size is the JAX script's default
    runs = [
        ("attractor", attractor, [], 600, 100, 0, ("step",)),
        ("disk", disk, ["--out"], 600, 60, 10,
         ("pm_kick_gather", "pm_deposit_mass", "pm_gather") + frame_k),
        ("collapse", collapse, ["--out"], 600, 60, 10,
         ("pm_kick_gather", "pm_deposit", "pm_gather") + frame_k),
        ("cluster_core", cluster_core, ["--out"], 400, 50, 8,
         ("step", "pm_deposit", "pm_gather") + frame_k),
        ("deep_zoom", deep_zoom, ["--out"], 300, 50, 6,
         ("step", "pm_deposit", "pm_gather", "radix_hist", "radix_pass")
         + frame_k),
        ("deep_zoom --exact", deep_zoom, ["--exact", "--out"], 300, 50, 6,
         ("step", "pm_deposit", "pm_gather", "pairwise_diff", "radix_hist",
          "radix_pass") + frame_k),
    ]

    class Records(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    def counts():
        c = launch_counts()
        c["pm_deposit_mass"] = pm_cuda.DEPOSIT_MASS_LAUNCHES
        c["pm_deposit"] -= c["pm_deposit_mass"]
        return c

    total = {}
    for label, mod, extra, steps, every, frames, must in runs:
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--device", "cuda"] + [a for e in extra for a in (
                (e, tmp) if e == "--out" else (e,))]
            log = Records()
            logging.getLogger("particle_sim_tpu_torch.engine").addHandler(log)
            out = io.StringIO()
            zero_launches()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    rc_code = mod.main(argv)
                torch.cuda.synchronize()
            finally:
                logging.getLogger("particle_sim_tpu_torch.engine") \
                    .removeHandler(log)
            wall = time.perf_counter() - t0
            got = counts()
            pngs = sorted(f for f in os.listdir(tmp) if f.endswith(".png"))
            lit = [int(read_png(os.path.join(tmp, f))[..., :3].max())
                   for f in pngs]
        lines = out.getvalue().splitlines()
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        if rc_code != 0:
            fail(f"phase 22 {label}: main returned {rc_code}")
        if len(lines) != steps // every:
            fail(f"phase 22 {label}: {len(lines)} lines, expected "
                 f"{steps // every}: {lines}")
        for k, ln in enumerate(lines):
            check_finite_line(ln)
            s = (k + 1) * every
            if not (ln.startswith(f"step {s}: ") or ln.startswith("{")
                    and json.loads(ln)["step"] == s):
                fail(f"phase 22 {label}: line {k} is not step {s}: {ln!r}")
        if len(pngs) != frames or not all(lit):
            fail(f"phase 22 {label}: frames {pngs}, brightest channel "
                 f"{lit} (want {frames} frames, none black)")
        # a step is the step kernel's launch or, on the single-level PM,
        # the kicked gather's
        missed = [k for k in must if got[k] == 0]
        if missed or got["step"] + got["pm_kick_gather"] != steps:
            fail(f"phase 22 {label}: launches {got}: {missed or 'step'} "
                 f"did not launch as expected")
        renderer = ("none" if not frames else "compact"
                    if got["compact"] == got["deposit"] == frames
                    else "sorted" if got["sorted_deposit"] else "scatter")
        warned = [m for m in log.messages if "pmx window overflow" in m]
        if ("--exact" in extra) != bool(warned) or len(warned) > 1:
            fail(f"phase 22 {label}: the truncation warning logged "
                 f"{len(warned)} times (want {int('--exact' in extra)}): "
                 f"{log.messages}")
        for ln in lines:
            print(f"  {label}: {ln}")
        # host-paced: a steady window of the same scene, the host clock
        # around steps that end in a synchronize
        args = mod.build_parser().parse_args(
            ["--device", "cuda"] + [e for e in extra if e != "--out"])
        eng, params, _ = mod.build(args)
        step_params = ((lambda i: attractor.orbit(params, i))
                       if mod is attractor else (lambda i: params))
        for i in range(3):
            eng.step(step_params(i))
        torch.cuda.synchronize()
        k_steady = 50
        t1 = time.perf_counter()
        for i in range(3, 3 + k_steady):
            eng.step(step_params(i))
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t1) * 1e3 / k_steady
        del eng
        print(f"phase 22 {label} ({' '.join(argv).replace(tmp, 'DIR')}, "
              f"{steps} steps): {wall:.3f} s of wall, {ms_step:.4f} ms a "
              f"step host-paced (steady, {k_steady} steps), {len(lines)} "
              f"finite lines, {len(pngs)} frames by the {renderer} "
              f"renderer, launches { {k: v for k, v in got.items() if v} }"
              + (f"; warned once: {warned[0]}" if warned else ""))

    # the first frame at 65,536 on the kernel path against the plain path:
    # both engines from the same scene, one step each (the plain engine
    # launches no kernel), then the kernel engine's frame through the
    # compact kernels against their plain versions (phase 3's bars)
    n_k = 65_536
    for label, mod, extra, *_ in runs:
        argv = ["--device", "cuda", "--count", str(n_k)] + [
            e for e in extra if e != "--out"]
        args = mod.build_parser().parse_args(argv)
        ek, params, camera = mod.build(args, Method.CUDA)
        ep, _, _ = mod.build(args, Method.TORCH)
        if not (torch.equal(ek.state.pos, ep.state.pos)
                and torch.equal(ek.state.vel, ep.state.vel)):
            fail(f"phase 22 {label}: the two engines start apart")
        if ek.pmx is not None:
            # past its capacity the persistent kernel path corrects the
            # first members in the mirror's slot order, the plain path
            # (accel_sorted_ref, identity order) others, by design: both
            # engines get a capacity that holds all ~16,900 members
            for e in (ek, ep):
                e.set_pmx(dataclasses.replace(ek.pmx, capacity=32_768))
        if mod is attractor:
            params = attractor.orbit(params, 0)
        p0 = ek.state.pos.clone()
        v0 = ek.state.vel.clone()
        zero_launches()
        ep.step(params)
        torch.cuda.synchronize()
        plain_launches = {k: v for k, v in launch_counts().items() if v}
        ek.step(params)
        torch.cuda.synchronize()
        k_launches = {k: v for k, v in launch_counts().items() if v}
        if plain_launches or not k_launches:
            fail(f"phase 22 {label} at {n_k}: the plain engine launched "
                 f"{plain_launches}, the kernel engine {k_launches}")
        sk, sp = ek.state, ep.state
        if ek.pmx is not None and not (
                ek.pmx_member_count() == ep.pmx_member_count()
                and ek.pmx_member_count()[0] <= ek.pmx.capacity):
            fail(f"phase 22 {label} at {n_k}: members (all, corrected) "
                 f"{ek.pmx_member_count()} on the kernel path, "
                 f"{ep.pmx_member_count()} on the plain path")
        if mod is attractor:
            # phase 2's bars for one step
            bar = "rtol = atol = 1e-6"
            e_p = check_close(f"phase 22 {label} pos", sk.pos, sp.pos,
                              1e-6, 1e-6)
            e_v = check_close(f"phase 22 {label} vel", sk.vel, sp.vel,
                              1e-6, 1e-6)
        else:
            # the gravity solvers kick then step: v1 = d (v0 + a dt),
            # p1 = p0 + (v0 + a dt) dt; the plain engine's a gives the
            # accelerations' bar of the phase that holds the same solver
            # (11/12 for pm, 16 for pm2, 19 for the persistent stack,
            # with pmx 1e-4 max|a| + 2e-4 max|a_x|); positions within dt^2
            # times it plus a few f32 roundings of |p| < 64 (phase 19)
            dt, damp = params.delta_time, params.damping
            a = (sp.vel / damp - v0) / dt
            a_max = float(a.abs().max())
            bar_a = 1e-4 * a_max
            if ek.pmx is not None:
                flat, na = p0.reshape(3, -1), sk.n_active
                g = ek.pairwise.gravitational_constant
                levels = pm2.as_levels(ek.pm2)
                a_x = (pmx.pmx_accel(flat, na, g, ek.pm, levels, ek.pmx)[0]
                       - pm2.pmn_accel(flat, na, g, ek.pm, levels))
                bar_a += 2e-4 * float(a_x.abs().max())
            bar_p = dt * dt * bar_a + 64 * 2.0 ** -20
            bar_v = dt * bar_a + float(sp.vel.abs().max()) * 2.0 ** -20
            bar = f"|a| {a_max:.4g}, |dp| <= {bar_p:.3g}, |dv| <= {bar_v:.3g}"
            e_p = check_close(f"phase 22 {label} pos", sk.pos, sp.pos, 0.0,
                              bar_p)
            e_v = check_close(f"phase 22 {label} vel", sk.vel, sp.vel, 0.0,
                              bar_v)
        note = ("" if ek.pmx is None else f"; pmx members (all, corrected) "
                f"{ek.pmx_member_count()} on both paths at capacity "
                f"{ek.pmx.capacity}")
        if camera is not None:
            pv = torch.from_numpy(params.pack()).to(dev)
            vp = torch.from_numpy(camera.view_proj()).to(dev)
            fargs = (sk.pos, sk.vel, sk.init_color, pv, vp, sk.n_active)
            fk = rc.render(*fargs, width=1280, height=720)
            fp = rc.render(*fargs, width=1280, height=720, plain=True)
            check_close(f"phase 22 {label} frame", fk, fp, 1e-4, 1e-5)
            u8 = int((raster.to_rgba8(fk).int()
                      - raster.to_rgba8(fp).int()).abs().max())
            lit_px = int((fk.sum(-1) > 0).sum())
            if u8 > 1 or lit_px < 100:
                fail(f"phase 22 {label} frame at {n_k}: u8 {u8}, {lit_px} "
                     f"lit pixels")
            note += (f"; the frame through the compact kernels vs plain "
                    f"within 1e-5 + 1e-4|p|, {u8} u8, {lit_px} lit pixels")
        print(f"phase 22 {label} first frame at {n_k}: kernel vs plain "
              f"engine max |dp| {e_p:.3g}, |dv| {e_v:.3g} ({bar}); kernel "
              f"launches {k_launches}, plain none{note}")
        del ek, ep
    print(f"phase 22 done in {time.perf_counter() - t_start:.1f} s")
    return {"launches": total}


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
        pairwise, pairwise_cuda, pm, pm2, pm_cuda, pm_fft, pmx, psort,
        step_cuda,
    )
    from particle_sim_tpu_torch.render import raster, raster_compact as rc
    from particle_sim_tpu_torch.render import raster_sorted as rs
    from particle_sim_tpu_torch.render.camera import Camera
    from particle_sim_tpu_torch.tools import pairwise_mxu_variants as mxv
    from particle_sim_tpu_torch.tools import pairwise_variants as pwv
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
    # probe): phase 14 times it in turns with the package's; and of the
    # direct force (variant 0 of tools/pairwise_variants.cu): phases 10 and
    # 17 time it in turns with the package's
    rv_jobs = raster_variants.start_builds(raster_variants.CONFIGS[:1])
    mx_jobs = mxv.start_builds(mxv.CONFIGS[:1])
    pw_jobs = pwv.start_builds(pwv.CONFIGS[:1])
    path, secs = cuda_build.build()
    cuda_build.library()
    (rv_lib,) = raster_variants.finish_builds(rv_jobs, show_registers=False)
    ((mx_v0_lib, _),) = mxv.finish_builds(mx_jobs)
    ((pw_v0_lib, pw_v0_path),) = pwv.finish_builds(pw_jobs)
    log = path.with_suffix(".log")
    regs = [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or ln.startswith("==")] if log.exists() else []
    print(f"phase 1 build: {os.path.relpath(path, ROOT)} in {secs:.2f} s "
          f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for ln in regs:
        print(f"  ptxas: {ln}")

    err = {"step": 0.0, "compact": 0.0, "deposit": 0.0, "pairwise": 0.0,
           "pairwise_diff": 0.0,
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
    # the difference pass (pmx's correction, eps 0.5 and 2.0), the live
    # counts (NaN past them in receivers, sources and masses: the rows past
    # n_i exactly 0), the ragged shapes (Ni not a multiple of the 512
    # receivers a block, Nj not of the 256 sources a tile); each against
    # its plain version at the same bar
    n_ci, n_cj = 50_000, 40_000
    nan_i = x.T.clone()
    nan_i[n_ci:] = float("nan")
    nan_j = x.clone()
    nan_j[:, n_cj:] = float("nan")
    nan_m = torch.ones(N_GRAVITY, dtype=torch.float32, device=dev)
    nan_m[n_cj:] = float("nan")
    cnt = dict(n_i=pm_cuda.device_const(n_ci, dev, torch.int32),
               n_j=pm_cuda.device_const(n_cj, dev, torch.int32))
    fin = x.T.contiguous()
    live_cases = [
        ("difference 0.5 / 2.0, square", True, x.T, x, {}),
        ("difference, central mass 1000", True, x.T, x,
         {"masses": masses}),
        (f"counts n_i {n_ci} n_j {n_cj}, NaN past them", False, nan_i, nan_j,
         dict(cnt, masses=nan_m)),
        (f"difference, counts n_i {n_ci} n_j {n_cj}, NaN past them", True,
         nan_i, nan_j, dict(cnt, masses=nan_m)),
        ("ragged 40001 x 30011", False, fin[:40_001], x[:, 7:30_018], {}),
        ("difference, ragged 40001 x 30011", True, fin[:40_001],
         x[:, 7:30_018], {}),
        ("ragged 1000 x 777, counts 999 / 700", False, fin[:1000],
         x[:, :777], {"n_i": 999, "n_j": 700}),
    ]
    for label, is_diff, xi_, xj_, kw in live_cases:
        if is_diff:
            got = pairwise_cuda.pairwise_accel_diff(xi_, xj_, N_GRAVITY, 1.0,
                                                    0.5, 2.0, **kw)
            want = pairwise.pairwise_accel_diff(xi_, xj_, N_GRAVITY, 1.0, 0.5,
                                                2.0, **kw)
        else:
            got = pairwise_cuda.pairwise_accel(xi_, xj_, N_GRAVITY, 1.0, 0.5,
                                               **kw)
            want = pairwise.pairwise_accel(xi_, xj_, N_GRAVITY, 1.0, 0.5,
                                           **kw)
        torch.cuda.synchronize()
        scale = want.abs().amax(0)
        e = check_close(f"pairwise {label}", got, want, 0.0,
                        1e-4 * scale[None, :])
        key = "pairwise_diff" if is_diff else "pairwise"
        err[key] = max(err[key], e)
        n_live = int(kw.get("n_i", xi_.shape[0]))
        if not bool((got[n_live:] == 0).all()):
            fail(f"pairwise {label}: a receiver past n_i is not 0")
        n_s = pairwise_cuda.source_slices(xi_.shape[0], xj_.shape[1],
                                          pairwise_cuda.sm_count(0))
        print(f"  pairwise {label}: max |k - p| {e:.3g} "
              f"({float(((got - want).abs().amax(0) / scale).max()):.3g} of "
              f"max|p| {float(scale.max()):.4g}), S {n_s}")
    # the same inputs give the same bits on every launch (no atomics)
    for label, fn in (
            ("square", lambda: pairwise_cuda.pairwise_accel(
                x.T, x, N_GRAVITY, 1.0, 0.5)),
            ("difference with counts", lambda: pairwise_cuda.
             pairwise_accel_diff(nan_i, nan_j, N_GRAVITY, 1.0, 0.5, 2.0,
                                 masses=nan_m, **cnt))):
        if not torch.equal(fn(), fn()):
            fail(f"pairwise {label}: two launches differ")
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
    print(f"phase 6 pairwise kernel == plain at {N_GRAVITY}: "
          f"{4 + len(live_cases)} cases (the difference pass, live counts "
          f"with NaN past them, ragged shapes), max |err| "
          f"{err['pairwise']:.3g}, difference {err['pairwise_diff']:.3g} "
          f"(bar 1e-4 max|p| per component); two launches bit for bit "
          f"(square, difference with counts); "
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
        # a refinement level and an exact window, as the viewer's panel
        # sends them (g, softening and pmx_softening at their defaults)
        before = (pm_cuda.DEPOSIT_LAUNCHES, pairwise_cuda.DIFF_LAUNCHES,
                  psort.RADIX_HIST_LAUNCHES)
        ws.send({"type": "solver", "name": "pm", "pm2_sizes": [32],
                 "pm2_softenings": [0.75], "pmx_size": 8,
                 "pmx_capacity": 16384, "seq": 8})
        ws.binary_until(lambda f: struct.unpack(
            server.HEADER_FMT, f[:hdr])[7] >= 8, "reflected_seq 8 (pm2/pmx)")
        stack_launches = {"pm_deposit": pm_cuda.DEPOSIT_LAUNCHES - before[0],
                          "pairwise_diff": pairwise_cuda.DIFF_LAUNCHES
                          - before[1],
                          "radix_hist": psort.RADIX_HIST_LAUNCHES
                          - before[2]}
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
    if hello2.get("solver") != "pm" or hello2.get("pm2_sizes") != [32.0] \
            or hello2.get("pm2_softenings") != [0.75] \
            or hello2.get("pmx_size") != 8.0:
        fail(f"server: the status after the pm events says {hello2}")
    if eng.pm2 != pm2.PM2Config(None, 32.0, 0.75) \
            or eng.pmx != pmx.PMXConfig(8.0, 0.1, capacity=16384):
        fail(f"server: the pm2/pmx event did not take ({eng.pm2}, "
             f"{eng.pmx})")
    if not (stack_launches["pm_deposit"] >= 2
            and stack_launches["pairwise_diff"] >= 1
            and stack_launches["radix_hist"] >= 1):
        fail(f"server: a step after the pm2/pmx event missed a kernel: "
             f"{stack_launches}")
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
          f"\"pm\" solver event, reflected (seq 7), then pm2_sizes [32] "
          f"and pmx_size 8 (seq 8): status solver {hello2.get('solver')!r}, "
          f"pm2_sizes {hello2.get('pm2_sizes')}, pmx_size "
          f"{hello2.get('pmx_size')}, launches from that event on "
          f"{stack_launches}; "
          f"launches {s_launches} ({s_wall:.2f} s); compact (bit-exact) and "
          f"deposit == plain on its state, deposit max |err| so far "
          f"{err['deposit']:.3g}")

    # -- phase 10: times of the gravity and sorted-frame kernels --------------------------
    clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    pairs = float(N_GRAVITY) * N_GRAVITY
    # the bound (operations over the FP32 peak, an fma as 2) beside the FP32 issue rate (only half the
    # instructions are fmas: it binds first) and the rsqrt rate
    pw_flops = flops_ms(PAIR_FLOPS * pairs)
    pw_issue = PAIR_FP32_INSTRS * pairs / FP32_INSTRS_PER_S * 1e3
    pw_rsqrt = pairs / RSQRT_PER_S * 1e3
    pw_bound = pw_flops
    pw_clock = PAIR_FP32_INSTRS * pairs / (132 * 128 * clk_mhz * 1e6) * 1e3
    pw_mix = sass_mix(path, "pairwise_kernelILb0")
    v0_mix = sass_mix(pw_v0_path, "2v015pairwise_kernel")
    # the probe's config 0 builds csrc/pairwise.cu with the package's
    # settings: its occupancy export reads the kernel's resources
    pw_occ = pwv.occupancy(pw_v0_lib, "pkg")
    pwd_occ = pwv.occupancy(pw_v0_lib, "diff")
    if (pw_occ["receivers_per_block"], pw_occ["tile"]) != (
            pairwise_cuda.RECEIVERS_PER_BLOCK, pairwise_cuda.SOURCE_TILE):
        fail(f"pairwise: the wrapper's block shape "
             f"({pairwise_cuda.RECEIVERS_PER_BLOCK}, "
             f"{pairwise_cuda.SOURCE_TILE}) is not the kernel's {pw_occ}")
    v0_occ = pwv.occupancy(pw_v0_lib, "v0")
    pw_sms = pairwise_cuda.sm_count(0)
    pw_s = pairwise_cuda.source_slices(N_GRAVITY, N_GRAVITY, pw_sms)
    v0_in = pwv.Inputs(x.T, x, N_GRAVITY, (0.5,))
    # the kernels line's time is the wrapper called with Python numbers,
    # as in every earlier run; beside it, in turns, the wrapper with the
    # count, G and eps on the device, as the engine passes them (a Python
    # number is uploaded by a blocking copy on every call, and the host
    # then paces the card), and variant 0 on the same device arguments
    pw_args = (pm_cuda.device_const(N_GRAVITY, dev, torch.int32),
               *pm_cuda.device_const((1.0, 0.5), dev))
    pw_ms, pwd_ms, pw0_ms = median_ms(
        [lambda: pairwise_cuda.pairwise_accel(x.T, x, N_GRAVITY, 1.0, 0.5),
         lambda: pairwise_cuda.pairwise_accel(x.T, x, *pw_args),
         lambda: pwv.v0_call(pw_v0_lib, v0_in)],
        reps=7, inner=5, lead_ms=5 * 4.0)
    (pwp_ms,) = median_ms(
        [lambda: pairwise.pairwise_accel(x.T, x, N_GRAVITY, 1.0, 0.5)],
        reps=3, inner=1)
    pw_clk = clocks_under_load(
        lambda: pairwise_cuda.pairwise_accel(x.T, x, *pw_args))
    print(f"phase 10 pairwise {N_GRAVITY}^2: the wrapper with Python "
          f"numbers {pw_ms:.4f} ms ({pairs / pw_ms * 1e3:.4g} pairs/s, "
          f"{pw_bound / pw_ms:.1%} of the bound) | in turns: the wrapper "
          f"with device arguments {pwd_ms:.4f} ms ({pw_bound / pwd_ms:.1%} "
          f"of the bound, {pw_issue / pwd_ms:.1%} of the FP32 issue rate) | "
          f"the earlier design (variant 0 of tools/pairwise_variants.cu) on "
          f"the same device arguments {pw0_ms:.4f} ms "
          f"({pw_bound / pw0_ms:.1%}; {pw0_ms / pwd_ms:.3f}x) | "
          f"plain {pwp_ms:.3f} ms"
          f" | bound {pw_bound:.4f} ms ({PAIR_FLOPS} flops/pair at 67 "
          f"TFLOP/s; beside it: {PAIR_FP32_INSTRS} FP32 instructions/pair at "
          f"128/SM/clock {pw_issue:.4f} ms, binds first; rsqrt at 16/SM/clock"
          f" {pw_rsqrt:.4f} ms; the issue rate at the reported max SM clock "
          f"{clk_mhz:.0f} MHz {pw_clock:.4f} ms) | library: none | "
          f"back to back: {pw_clk}")
    print(f"phase 10 pairwise kernel: R {pw_occ['receivers_per_thread']} "
          f"receivers a thread, {pw_occ['threads']} threads, "
          f"{pw_occ['registers']} registers, {pw_occ['blocks_per_sm']} "
          f"blocks an SM, {pw_occ['local_bytes']} B local, S {pw_s} source "
          f"slices at {N_GRAVITY} ({pw_sms} SMs), a pair: "
          f"{mix_per_pair(pw_mix)} | the difference pass: "
          f"{pwd_occ['registers']} registers, "
          f"{pwd_occ['blocks_per_sm']} blocks an SM, a pair: "
          f"{mix_per_pair(sass_mix(path, 'pairwise_kernelILb1'), 2)} | "
          f"variant 0: {v0_occ['registers']} registers, "
          f"{v0_occ['blocks_per_sm']} blocks of {v0_occ['threads']} an SM, "
          f"{-(-N_GRAVITY // 256)} blocks, a pair: {mix_per_pair(v0_mix)}")
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
            pm_cuda.DEPOSIT_SORTED_LAUNCHES = 0
            pm_cuda.GATHER_LAUNCHES = pm_cuda.KICK_GATHER_LAUNCHES = 0
            psort.RADIX_HIST_LAUNCHES = psort.RADIX_PASS_LAUNCHES = 0
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc_code = cli.main(argv)
            wall = time.perf_counter() - t0
            got = {"pm_deposit": pm_cuda.DEPOSIT_LAUNCHES,
                   "pm_deposit_mass": pm_cuda.DEPOSIT_MASS_LAUNCHES,
                   "pm_deposit_sorted": pm_cuda.DEPOSIT_SORTED_LAUNCHES,
                   "pm_gather": pm_cuda.GATHER_LAUNCHES,
                   "pm_kick_gather": pm_cuda.KICK_GATHER_LAUNCHES,
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
        # each diagnostics line of (a) deposits and gathers once more; a
        # step's gather is its kicked gather
        n_diag = sum("potential" in ln for ln in lines)
        want = {"pm_deposit": steps_ + n_diag if tag == "a" else 0,
                "pm_deposit_mass": 0 if tag == "a" else steps_,
                "pm_deposit_sorted": 0,
                "pm_gather": steps_ + n_diag, "pm_kick_gather": steps_,
                "step": 0,
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
             lambda: pm.solve_accel(rho, cfg, cfg.softening, fused=True),
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

    # -- phase 16: pm2 / pmn at 1M: refinement levels on the PM kernels ----------------
    t0 = time.perf_counter()
    # bench.py's two-level scene: half a N(sigma 2) clump at (5, 4, -3),
    # half a N(sigma 20) halo, clipped to +-60; G = 128 over the static box
    n_c = 1_048_576
    rng_c = np.random.default_rng(0)
    clump = (rng_c.normal(size=(n_c // 2, 3)) * 2.0
             + np.array([5, 4, -3])).astype(np.float32)
    halo = (rng_c.normal(size=(n_c - n_c // 2, 3)) * 20.0).astype(np.float32)
    c_np = np.clip(np.concatenate([clump, halo]), -60, 60)
    c_pos = torch.from_numpy(np.ascontiguousarray(c_np.T)).to(dev)
    c_n = torch.tensor(n_c, dtype=torch.int32, device=dev)
    live_c = pm.live_mask(n_c, c_n, dev)
    cfg_c = PMConfig(softening=3.0)
    lv1 = pm2.PM2Config(window_min=None, window_size=32.0, softening=0.75)
    lv2 = pm2.PM2Config(window_min=None, window_size=8.0, softening=0.25)
    stacks = {"pm2": (lv1,), "pmn": (lv1, lv2)}
    # bar: pm_accel's of phase 11, 1e-4 max|a| (the deposit's f32 sums in
    # another order, within 1e-5 of max|p| a grid, through the linear
    # solves; the gather reads the same weights in the same order)
    pm2_rel = 0.0
    for name, levels in stacks.items():
        ak = pm2.pmn_accel(c_pos, c_n, 1.0, cfg_c, levels)
        ap = pm2.pmn_accel_ref(c_pos, c_n, 1.0, cfg_c, levels)
        torch.cuda.synchronize()
        scale = float(ap.abs().max())
        e = check_close(f"{name} 1M kernels vs plain", ak, ap, 0.0,
                        1e-4 * scale)
        pm2_rel = max(pm2_rel, e / scale)
        wms = pm2._nested_wmins(c_pos, live_c, cfg_c, levels, None)
        notes = [f"level {k + 1} ({c2.window_size:g}, eps {c2.softening:g})"
                 f" origin {[round(v, 4) for v in w.tolist()]} members "
                 f"{int((pm2._in_window(c_pos, w, c2.window_size, 0.0) & live_c).sum())}"
                 for k, (c2, w) in enumerate(zip(levels, wms))]
        print(f"  {name} 1M kernels vs plain: max |k - p| {e:.3g} = "
              f"{e / scale:.3g} of max|a| {scale:.6g} (bar 1e-4); "
              + "; ".join(notes))
    # dead slots poisoned with NaN under a static stack: the kernels never
    # read a dead particle's position (live), so nothing reaches a grid
    st_lv = (pm2.PM2Config((-11.0, -12.0, -19.0), 32.0, 0.75),
             pm2.PM2Config((1.0, 0.0, -7.0), 8.0, 0.25))
    n_live = n_c - 4096
    n_live_t = torch.tensor(n_live, dtype=torch.int32, device=dev)
    poisoned = c_pos.clone()
    poisoned[:, n_live:] = float("nan")
    a_clean = pm2.pmn_accel(c_pos, n_live_t, 1.0, cfg_c, st_lv)
    a_nan = pm2.pmn_accel(poisoned, n_live_t, 1.0, cfg_c, st_lv)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(a_nan).all())
            and bool((a_nan[:, n_live:] == 0).all())):
        fail("pmn: NaN in dead slots reached the result")
    e_nan = check_close("pmn NaN-poisoned dead slots", a_nan, a_clean, 0.0,
                        1e-4 * float(a_clean.abs().max()))

    def ball(rng, n, radius, offset=(0.0, 0.0, 0.0)):
        """tests/test_pm2.py's generator: uniform in a ball."""
        b = rng.normal(size=(n, 3)).astype(np.float32)
        b /= np.linalg.norm(b, axis=1, keepdims=True)
        r = radius * rng.random(n).astype(np.float32) ** (1 / 3)
        return (b * r[:, None] + np.asarray(offset, np.float32)).astype(
            np.float32)

    def padded(pts):
        cap = -(-pts.shape[0] // 512) * 512
        full = np.concatenate([pts, np.zeros((cap - pts.shape[0], 3),
                                             np.float32)])
        return torch.from_numpy(np.ascontiguousarray(full.T)).to(dev)

    def rms_to(a, ref, mask):
        mag = ref[:, mask].norm(dim=0).mean()
        return float((a[:, mask] - ref[:, mask]).norm(dim=0).pow(2).mean()
                     .sqrt() / mag)

    # tests/test_pm2.py's own scene and bars through the kernels: inside
    # the window (margin 12) two-level PM against the direct sum at the
    # fine eps 0.75 (the pairwise kernel), rms < 0.03 and < coarse / 10
    rng_s = np.random.default_rng(0)
    s_np = np.concatenate([ball(rng_s, 3000, 5.0), ball(rng_s, 1000, 45.0)])
    s_pos, n_s = padded(s_np), s_np.shape[0]
    cfg2_s = pm2.PM2Config(window_min=(-16.0,) * 3, window_size=32.0,
                           softening=0.75)
    a2_s = pm2.pm2_accel(s_pos, n_s, 1.0, cfg_c, cfg2_s)[:, :n_s]
    ac_s = pm_cuda.pm_accel(s_pos, n_s, 1.0, cfg_c)[:, :n_s]
    ad_s = pairwise_cuda.pairwise_accel(s_pos.T.contiguous(), s_pos, n_s,
                                        1.0, 0.75).T[:, :n_s]
    inner_s = torch.from_numpy(np.all((s_np >= -4.0) & (s_np < 4.0),
                                      axis=1)).to(dev)
    r2_s, rc_s = rms_to(a2_s, ad_s, inner_s), rms_to(ac_s, ad_s, inner_s)
    if not (int(inner_s.sum()) > 2000 and r2_s < 0.03 and rc_s > 0.3
            and r2_s < rc_s / 10):
        fail(f"pm2 on tests/test_pm2.py's scene: rms {r2_s:.4g} (bar 0.03),"
             f" coarse {rc_s:.4g}, {int(inner_s.sum())} inner")
    # tests/test_pmn.py's scene and bars: each level cuts the core's rms
    # against the direct sum at the innermost eps 0.25
    core_c = np.array([5.0, 4.0, -3.0], np.float32)
    rng_n = np.random.default_rng(0)
    n_np = np.concatenate([ball(rng_n, 1500, 1.2, core_c),
                           ball(rng_n, 2000, 5.0, core_c),
                           ball(rng_n, 1000, 45.0)])
    n_pos, n_n = padded(n_np), n_np.shape[0]
    ad_n = pairwise_cuda.pairwise_accel(n_pos.T.contiguous(), n_pos, n_n,
                                        1.0, 0.25).T[:, :n_n]
    core_n = torch.from_numpy(np.linalg.norm(n_np - core_c, axis=1)
                              < 1.0).to(dev)
    r_lv = [rms_to(fn()[:, :n_n], ad_n, core_n) for fn in (
        lambda: pm_cuda.pm_accel(n_pos, n_n, 1.0, cfg_c),
        lambda: pm2.pmn_accel(n_pos, n_n, 1.0, cfg_c, (lv1,)),
        lambda: pm2.pmn_accel(n_pos, n_n, 1.0, cfg_c, (lv1, lv2)))]
    if not (r_lv[2] < 0.06 and r_lv[2] < r_lv[1] / 3
            and r_lv[1] < r_lv[0] / 2):
        fail(f"pmn on tests/test_pmn.py's scene: rms coarse / 1 level / 2 "
             f"levels {r_lv} (bars: 2 levels < 0.06, each level / 3, / 2)")

    # the three-level stack through the engine (the kernel path), for the
    # launch counts: 3 deposits and gathers, the momentum sums and 1 step
    # kernel (its kicked form) a frame
    steps_c = 20
    eng_c = Engine(particle_count=n_c, device="cuda", method=Method.CUDA,
                   pm=cfg_c, pm2=(lv1, lv2))
    eng_c.state = ParticleState.from_arrays(
        c_np, np.zeros_like(c_np), gen.initial_colors(c_np), device=dev)
    step_cuda.LAUNCHES = 0
    pm_cuda.DEPOSIT_LAUNCHES = pm_cuda.DEPOSIT_MASS_LAUNCHES = 0
    pm_cuda.GATHER_LAUNCHES = 0
    pm_cuda.MOMENTUM_LAUNCHES = pm_cuda.KICK_FUSED_LAUNCHES = 0
    for _ in range(steps_c):
        eng_c.step(SimParams(delta_time=0.004))
    torch.cuda.synchronize()
    pmn_launches = {"pm_deposit": pm_cuda.DEPOSIT_LAUNCHES,
                    "pm_deposit_mass": pm_cuda.DEPOSIT_MASS_LAUNCHES,
                    "pm_gather": pm_cuda.GATHER_LAUNCHES,
                    "pm_momentum": pm_cuda.MOMENTUM_LAUNCHES,
                    "pm_kick_fused": pm_cuda.KICK_FUSED_LAUNCHES,
                    "step": step_cuda.LAUNCHES}
    want = {"pm_deposit": 3 * steps_c, "pm_deposit_mass": 0,
            "pm_gather": 3 * steps_c, "pm_momentum": steps_c,
            "pm_kick_fused": steps_c, "step": steps_c}
    if pmn_launches != want:
        fail(f"the pmn engine path missed a kernel: launches {pmn_launches},"
             f" expected {want}")
    if not np.isfinite(eng_c.state.positions()).all():
        fail("pmn engine: non-finite state")
    del eng_c

    # times (device, CUDA events, dt = 0 so every call does the same work)
    pv0 = torch.from_numpy(SimParams(delta_time=0.0).pack()).to(dev)
    pp_c = torch.from_numpy(PairwiseParams(1.0, 3.0).pack()).to(dev)
    sp = c_pos.clone().reshape(3, -1, 128)
    sv = torch.zeros_like(sp)
    box_t, cell_t = pm_cuda.static_box(tuple(cfg_c.box_min),
                                       float(cfg_c.cell_size), dev)
    rho_c = pm_cuda.deposit(c_pos, c_n, box_t, cell_t, 128, periodic=False)
    grids_c = pm.solve_accel(rho_c, cfg_c, cfg_c.softening)
    lay = [("coarse deposit", lambda: pm_cuda.deposit(
                c_pos, c_n, box_t, cell_t, 128, periodic=False)),
           ("coarse solve", lambda: pm.solve_accel(rho_c, cfg_c, 3.0,
                                                   fused=True)),
           ("coarse gather", lambda: pm_cuda.gather(
                grids_c, c_pos, c_n, box_t, cell_t, periodic=False))]
    wms = pm2._nested_wmins(c_pos, live_c, cfg_c, (lv1, lv2), None)
    eo, fine_rho = cfg_c.softening, []
    for k, (c2, w) in enumerate(zip((lv1, lv2), wms)):
        h2 = c2.window_size / 128
        cell2 = pm_cuda.device_const((h2,), dev)
        inner = pm2._in_window(c_pos, w, c2.window_size, c2.margin) & live_c
        rho2 = pm_cuda.deposit(c_pos, c_n, w, cell2, 128, periodic=False,
                               live=inner)
        g2 = pm.solve_accel_diff(rho2, 128, h2, c2.softening, eo)
        fine_rho.append(rho2)
        lay += [(f"level {k + 1} deposit",
                 lambda w=w, c=cell2, i=inner: pm_cuda.deposit(
                     c_pos, c_n, w, c, 128, periodic=False, live=i)),
                (f"level {k + 1} solve",
                 lambda r=rho2, h=h2, e=c2.softening, o=eo:
                     pm.solve_accel_diff(r, 128, h, e, o, fused=True)),
                (f"level {k + 1} gather",
                 lambda g_=g2, w=w, c=cell2, i=inner: pm_cuda.gather(
                     g_, c_pos, c_n, w, c, periodic=False, live=i))]
        eo = c2.softening
    acc_c = pm2.pmn_accel(c_pos, c_n, 1.0, cfg_c, (lv1, lv2))
    lay += [("window origins (2 levels)", lambda: pm2._nested_wmins(
                c_pos, live_c, cfg_c, (lv1, lv2), None)),
            ("momentum_clean", lambda: pm.momentum_clean(acc_c, c_n)),
            ("whole PM step", lambda: pm_cuda.step_pm(
                sp, sv, pv0, pp_c, c_n, cfg_c)),
            ("whole pm2 step", lambda: pm2.step_pmn(
                sp, sv, pv0, pp_c, c_n, cfg_c, (lv1,))),
            ("whole pmn step", lambda: pm2.step_pmn(
                sp, sv, pv0, pp_c, c_n, cfg_c, (lv1, lv2))),
            ("solve_accel_pair (coarse + level 1)", lambda: pm.solve_accel_pair(
                rho_c, fine_rho[0], cfg_c, 3.0,
                pm2.fine_kernels(cfg_c, lv1, device=dev))),
            ("solve_accel + solve_accel_diff", lambda: (
                pm.solve_accel(rho_c, cfg_c, 3.0),
                pm.solve_accel_diff(fine_rho[0], 128, 0.25, 0.75, 3.0)))]
    lay_ms = median_ms([fn for _, fn in lay], reps=5, inner=5, lead_ms=20.0)
    pm2_timing = dict(zip((nm for nm, _ in lay), lay_ms))
    pair = pm.solve_accel_pair(rho_c, fine_rho[0], cfg_c, 3.0,
                               pm2.fine_kernels(cfg_c, lv1, device=dev))
    sep = (pm.solve_accel(rho_c, cfg_c, 3.0),
           pm.solve_accel_diff(fine_rho[0], 128, 0.25, 0.75, 3.0))
    for a_, b_ in zip(pair, sep):
        check_close("solve_accel_pair vs the two solves", a_, b_, 0.0,
                    1e-5 * float(b_.abs().max()))
    print("  pm2/pmn layers 1M G=128 (two levels 32/0.75, 8/0.25): " + " | ".join(
        f"{nm} {ms:.5f} ms" for nm, ms in pm2_timing.items()))
    print(f"phase 16 pm2/pmn at {n_c}: kernels == plain (max "
          f"{pm2_rel:.3g} of max|a|, bar 1e-4), NaN dead slots {e_nan:.3g};"
          f" tests/test_pm2.py's scene rms {r2_s:.4g} (bar 0.03; coarse "
          f"{rc_s:.4g}); tests/test_pmn.py's core rms coarse {r_lv[0]:.4g}"
          f" / one level {r_lv[1]:.4g} / two {r_lv[2]:.4g} (bar 0.06); "
          f"engine pmn x {steps_c} launches {pmn_launches}; step PM "
          f"{pm2_timing['whole PM step']:.4f} / pm2 "
          f"{pm2_timing['whole pm2 step']:.4f} / pmn "
          f"{pm2_timing['whole pmn step']:.4f} ms; solve_accel_pair "
          f"{pm2_timing['solve_accel_pair (coarse + level 1)']:.4f} against "
          f"two solves {pm2_timing['solve_accel + solve_accel_diff']:.4f} ms"
          f" ({time.perf_counter() - t0:.1f} s)")
    del c_pos, poisoned, sp, sv, acc_c, ak, ap, a_clean, a_nan

    # -- phase 17: pmx at 1M: the window-exact correction -----------------------
    t0 = time.perf_counter()
    lib_calls0 = psort.LIBRARY_CALLS
    # bench.py's pmx scene: 1M uniform in [-45, 45]^3, coarse eps 2.0, a
    # tracked window of 32 at eps 0.5, capacity 65,536 (~45k members)
    n_x = 1_048_576
    gen_x = torch.Generator(device=dev).manual_seed(7)
    x_pos = (torch.rand((3, n_x), generator=gen_x, device=dev) * 90.0
             - 45.0).contiguous()
    x_n = torch.tensor(n_x, dtype=torch.int32, device=dev)
    live_x = pm.live_mask(n_x, x_n, dev)
    cfg_xm = PMConfig(softening=2.0)
    cfgx = pmx.PMXConfig(window_size=32.0, softening=0.5, capacity=65536)
    b_x = cfgx.capacity
    wmin_x = pm2.window_min(x_pos, None, cfgx, None, live=live_x)
    member = pmx._member_mask(x_pos, wmin_x, cfgx, live_x)
    slots = torch.nonzero(member).squeeze(1)
    n_mem = int(slots.shape[0])
    idx_k = pmx.members_first(member)
    if not torch.equal(idx_k[:n_mem].long(), slots):
        fail("pmx: the compaction's members are not the members in slot "
             "order")
    corr_k, nm_k = pmx.exact_accel(x_pos, live_x, cfgx, 2.0, wmin=wmin_x)
    corr_p, nm_p = pmx.exact_accel(x_pos, live_x, cfgx, 2.0, wmin=wmin_x,
                                   use_kernels=False)
    if not int(nm_k) == int(nm_p) == n_mem:
        fail(f"pmx member counts: kernels {int(nm_k)}, plain {int(nm_p)}, "
             f"mask {n_mem}")
    # the compact buffer, for the bar's scale and the layer times
    idx_b = idx_k[:b_x].long()
    buf = x_pos.index_select(1, idx_b)
    rec = buf.T.contiguous()
    m_buf = (torch.arange(b_x, device=dev) < min(n_mem, b_x)).float()
    n_b, one, eps_x, eps_c = (pm_cuda.device_const(b_x, dev, torch.int32),
                              *pm_cuda.device_const((1.0, 0.5, 2.0), dev))
    n_in = pm_cuda.device_const(min(n_mem, b_x), dev, torch.int32)
    a_x = pairwise_cuda.pairwise_accel(rec, buf, n_b, one, eps_x,
                                       masses=m_buf)
    a_p = pairwise_cuda.pairwise_accel(rec, buf, n_b, one, eps_c,
                                       masses=m_buf)
    torch.cuda.synchronize()
    # bar: each pass within 1e-4 max|p| of plain (phase 6's pairwise
    # bar), so the difference within 2e-4 max|a_x| (|a_p| <= |a_x|): the
    # correction a_x - a_p is a small difference of two large sums
    sx = float(a_x.abs().max())
    e_corr = check_close("pmx correction 1M", corr_k, corr_p, 0.0, 2e-4 * sx)
    err["pairwise_diff"] = max(err["pairwise_diff"], e_corr)
    ax_k, nx_k = pmx.pmx_accel(x_pos, x_n, 1.0, cfg_xm, (), cfgx)
    ax_p, nx_p = pmx.pmx_accel(x_pos, x_n, 1.0, cfg_xm, (), cfgx,
                               use_fast=False)
    torch.cuda.synchronize()
    sm = float(ax_p.abs().max())
    e_acc = check_close("pmx_accel 1M", ax_k, ax_p, 0.0,
                        1e-4 * sm + 2e-4 * sx)
    if not int(nx_k) == int(nx_p) == n_mem:
        fail(f"pmx_accel member counts {int(nx_k)} / {int(nx_p)} / {n_mem}")
    # overflow: capacity 16,384 < the members: exactly the first 16,384 by
    # slot order keep a correction, everyone else gets 0
    small = pmx.PMXConfig(window_size=32.0, softening=0.5, capacity=16384)
    corr_t, nm_t = pmx.exact_accel(x_pos, live_x, small, 2.0, wmin=wmin_x)
    corr_tp, _ = pmx.exact_accel(x_pos, live_x, small, 2.0, wmin=wmin_x,
                                 use_kernels=False)
    torch.cuda.synchronize()
    kept, dropped = slots[:16384], slots[16384:]
    if not (int(nm_t) == n_mem > 16384
            and bool((corr_t[:, dropped] == 0).all())
            and bool((corr_t[:, ~member] == 0).all())
            and float(corr_t[:, kept].abs().max()) > 0.0):
        fail(f"pmx overflow: count {int(nm_t)}, dropped members or "
             f"non-members corrected, or a kept member without one")
    e_trunc = check_close("pmx overflow correction", corr_t, corr_tp, 0.0,
                          2e-4 * sx)

    def scan_members_first(mem, cap):
        """The prefix-sum compaction (timed beside the sort): each
        member's rank by an inclusive cumsum, scattered to its slot
        (ranks past cap go to a dump slot). -> int32[cap], the members
        first in slot order (the rest of the slots unset)."""
        rank = torch.cumsum(mem, 0, dtype=torch.int32) - 1
        dest = torch.where(mem & (rank < cap), rank, cap).long()
        out = torch.zeros(cap + 1, dtype=torch.int32, device=mem.device)
        out.scatter_(0, dest, torch.arange(mem.shape[0], dtype=torch.int32,
                                           device=mem.device))
        return out[:cap]

    if not torch.equal(scan_members_first(member, b_x)[:n_mem],
                       idx_k[:n_mem]):
        fail("pmx: the prefix-sum compaction differs from the sort's")
    corr_buf = (a_x - a_p).T.contiguous()
    # the difference pass against two passes of the earlier design over
    # the whole capacity (what pmx ran before), and the plain difference
    d_in = pwv.Inputs(rec, buf, b_x, (0.5, 2.0), masses=m_buf)

    def diff_pass():
        return pairwise_cuda.pairwise_accel_diff(
            rec, buf, n_b, one, eps_x, eps_c, masses=m_buf, n_i=n_in,
            n_j=n_in)

    dk_ms, d0_ms = median_ms(
        [diff_pass, lambda: (pwv.v0_call(pw_v0_lib, d_in),
                             pwv.v0_call(pw_v0_lib, d_in, eps_k=1))],
        reps=7, inner=5, lead_ms=5 * 5.0)
    (dp_ms,) = median_ms([lambda: pairwise.pairwise_accel_diff(
        rec, buf, n_b, one, eps_x, eps_c, masses=m_buf, n_i=n_in,
        n_j=n_in)], reps=3, inner=1)
    mem_pairs = float(min(n_mem, b_x)) ** 2
    d_s = pairwise_cuda.source_slices(b_x, b_x, pairwise_cuda.sm_count(0))
    d_flops = flops_ms(DIFF_PAIR_FLOPS * mem_pairs)
    d_issue = DIFF_PAIR_FP32_INSTRS * mem_pairs / FP32_INSTRS_PER_S * 1e3
    d_rsqrt = 2 * mem_pairs / RSQRT_PER_S * 1e3
    print(f"  pmx correction 1M, {min(n_mem, b_x)} in-budget members of "
          f"{b_x}: the difference pass {dk_ms:.4f} ms | two passes of the "
          f"earlier design over the capacity, in turns, {d0_ms:.4f} ms | "
          f"plain {dp_ms:.3f} ms | bound at the members' pairs "
          f"{d_flops:.4f} ms ({DIFF_PAIR_FLOPS} flops/pair at 67 TFLOP/s; "
          f"beside it: {DIFF_PAIR_FP32_INSTRS} FP32 instructions/pair "
          f"{d_issue:.4f} ms; 2 rsqrt/pair at 16/SM/clock {d_rsqrt:.4f} ms, "
          f"binds first); S {d_s}")
    xp = x_pos.clone().reshape(3, -1, 128)
    xv = torch.zeros_like(xp)
    pp_x = torch.from_numpy(PairwiseParams(1.0, 2.0).pack()).to(dev)
    psort.RADIX_HIST_LAUNCHES = psort.RADIX_PASS_LAUNCHES = 0
    lay = [("window origin + member mask", lambda: pmx._member_mask(
                x_pos, pm2.window_min(x_pos, None, cfgx, None, live=live_x),
                cfgx, live_x)),
           ("compaction: radix sort of (flag, idx)",
            lambda: pmx.members_first(member)),
           ("compaction: prefix sum + scatter",
            lambda: scan_members_first(member, b_x)),
           ("compaction: torch.sort of the flag (library)",
            lambda: torch.sort((~member).to(torch.int32), stable=True)),
           ("buffer gather (index_select)",
            lambda: x_pos.index_select(1, idx_b)),
           ("the difference pass", diff_pass),
           ("scatter (index_copy_)", lambda: torch.zeros(
                (3, n_x), device=dev).index_copy_(1, idx_b, corr_buf)),
           ("exact_accel", lambda: pmx.exact_accel(
                x_pos, live_x, cfgx, 2.0, wmin=wmin_x)),
           ("whole PM step", lambda: pm_cuda.step_pm(
                xp, xv, pv0, pp_x, x_n, cfg_xm)),
           ("whole pmx step", lambda: pmx.step_pmx(
                xp, xv, pv0, pp_x, x_n, cfg_xm, (), cfgx))]
    lay_ms = median_ms([fn for _, fn in lay], reps=5, inner=5, lead_ms=40.0)
    pmx_timing = dict(zip((nm for nm, _ in lay), lay_ms))
    print("  pmx layers 1M (window 32, capacity 65536, "
          f"{n_mem} members): " + " | ".join(
              f"{nm} {ms:.5f} ms" for nm, ms in pmx_timing.items()))
    print(f"phase 17 pmx at {n_x}: {n_mem} members (kernels == plain == the"
          f" mask, members first in slot order); correction max |k - p| "
          f"{e_corr:.3g} (bar 2e-4 max|a_x| {sx:.6g}), pmx_accel "
          f"{e_acc:.3g} (bar 1e-4 max|a| {sm:.6g} + 2e-4 max|a_x|); capacity"
          f" 16384: the first 16384 members by slot corrected, the rest "
          f"exactly 0, == plain within {e_trunc:.3g}; compaction sort "
          f"{pmx_timing['compaction: radix sort of (flag, idx)']:.5f} ms, "
          f"prefix sum {pmx_timing['compaction: prefix sum + scatter']:.5f}"
          f" ms; pmx step {pmx_timing['whole pmx step']:.4f} ms "
          f"({time.perf_counter() - t0:.1f} s)")
    del x_pos, xp, xv, buf, rec, corr_k, corr_p, ax_k, ax_p, corr_t, corr_tp

    # -- phase 18: the README's pmx command through the CLI ---------------------------
    n_r, steps_r = 1_000_000, 300
    with tempfile.TemporaryDirectory() as tmp:
        final = os.path.join(tmp, "final.npz")
        argv = ["--device", "cuda", "--count", str(n_r), "--steps",
                str(steps_r), "--pm", "--pm2-size", "24", "--pm2-softening",
                "0.8", "--pmx-size", "6", "--pmx-softening", "0.1",
                "--stats-every", "100", "--checkpoint-every", str(steps_r),
                "--checkpoint", final]
        step_cuda.LAUNCHES = pairwise_cuda.LAUNCHES = 0
        pairwise_cuda.DIFF_LAUNCHES = 0
        pm_cuda.DEPOSIT_LAUNCHES = pm_cuda.DEPOSIT_MASS_LAUNCHES = 0
        pm_cuda.DEPOSIT_SORTED_LAUNCHES = pm_cuda.GATHER_LAUNCHES = 0
        pm_cuda.MOMENTUM_LAUNCHES = pm_cuda.KICK_FUSED_LAUNCHES = 0
        psort.RADIX_HIST_LAUNCHES = psort.RADIX_PASS_LAUNCHES = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc_code = cli.main(argv)
        wall_r = time.perf_counter() - t0
        pmx_launches = {"pm_deposit": pm_cuda.DEPOSIT_LAUNCHES,
                        "pm_deposit_mass": pm_cuda.DEPOSIT_MASS_LAUNCHES,
                        "pm_deposit_sorted": pm_cuda.DEPOSIT_SORTED_LAUNCHES,
                        "pm_gather": pm_cuda.GATHER_LAUNCHES,
                        "pm_momentum": pm_cuda.MOMENTUM_LAUNCHES,
                        "pm_kick_fused": pm_cuda.KICK_FUSED_LAUNCHES,
                        "pairwise": pairwise_cuda.LAUNCHES,
                        "pairwise_diff": pairwise_cuda.DIFF_LAUNCHES,
                        "radix_hist": psort.RADIX_HIST_LAUNCHES,
                        "radix_pass": psort.RADIX_PASS_LAUNCHES,
                        "step": step_cuda.LAUNCHES}
        text = out.getvalue()
        for ln in text.splitlines():
            print(f"  cli (pmx): {ln}")
        if rc_code != 0:
            fail(f"pmx cli returned {rc_code}")
        lines = [json.loads(ln) for ln in text.strip().splitlines()]
        with np.load(final) as z:
            p_end, v_end = z["positions"], z["velocities"]
            meta_r = json.loads(str(z["meta"]))
    if lines[-1].get("done") is not True or lines[-1].get("steps") != steps_r \
            or [ln.get("step") for ln in lines[:-1]] != [100, 200, 300]:
        fail(f"pmx cli: stats / done lines {lines}")
    want = {"pm_deposit": 2 * steps_r, "pm_deposit_mass": 0,
            "pm_deposit_sorted": 0, "pm_gather": 2 * steps_r,
            "pm_momentum": steps_r, "pm_kick_fused": steps_r, "pairwise": 0,
            "pairwise_diff": steps_r, "radix_hist": steps_r,
            "radix_pass": psort.radix_digits() * steps_r, "step": steps_r}
    if pmx_launches != want:
        fail(f"the pmx cli path missed a kernel: launches {pmx_launches}, "
             f"expected {want}")
    if psort.LIBRARY_CALLS != lib_calls0:
        fail(f"pm2/pmx took the torch.sort route "
             f"{psort.LIBRARY_CALLS - lib_calls0} times")
    if p_end.shape != (n_r, 3) or not (np.isfinite(p_end).all()
                                       and np.isfinite(v_end).all()):
        fail("pmx cli: final state not finite or misshapen")
    if meta_r["pm2"]["window_size"] != 24.0 \
            or meta_r["pmx"]["window_size"] != 6.0:
        fail(f"pmx cli: checkpoint meta {meta_r['pm2']} {meta_r['pmx']}")
    mom_r, com_r = momentum_and_com(gen.generate(n_r)[0].astype(np.float64),
                                    p_end, v_end, np.ones(n_r))
    if not (mom_r < 1e-3 and com_r < 0.5):
        fail(f"pmx cli: |P| / sum m|v| = {mom_r:.3g} (bar 1e-3), centre of "
             f"mass moved {com_r:.3g} (bar 0.5)")
    print(f"phase 18 pmx main path: cli {n_r} x {steps_r} steps (pm2 24 / "
          f"0.8, pmx 6 / 0.1) in {wall_r:.2f} s, "
          f"{lines[-1].get('update_ms')} ms a step (host), |P| / sum m|v| "
          f"{mom_r:.3g}, centre of mass moved {com_r:.3g}, launches "
          f"{pmx_launches}, torch.sort route 0 times in phases 17-18")

    # -- phase 19: the persistent cell-sorted PM ------------------------------------
    p19 = phase19(dev, states)["launches"]

    # -- phase 20: the mesh path at world size 1 under NCCL ----------------------
    p20 = phase20(dev, states)["launches"]

    # -- phase 21: the packaging tool --------------------------------------------
    phase21(dev)

    # -- phase 22: the worked examples -------------------------------------------
    p22 = phase22(dev)["launches"]

    # -- phase 23: the PM step's tail in two launches -----------------------------
    p23 = phase23(dev)["launches"]

    # -- phase 24: the PM solve around cuFFT --------------------------------------
    r24 = phase24(dev)
    p24 = r24["launches"]

    # -- phase 25: the single-level PM tail from the grids ---------------------------
    p25 = phase25(dev)["launches"]

    # -- phase 26: the refinement windows' bookkeeping in one pass a window -----------
    r26 = phase26(dev)
    p26 = r26["launches"]

    src = "particle_sim_tpu_torch/csrc/"
    kernels = [
        {"name": "step", "route": "cuda", "source": src + "step.cu",
         "replaces": "particle_sim_tpu/ops/step_pallas.py:38",
         "launches": launches["step"] + pmn_launches["step"]
         + pmx_launches["step"] + p19["step"] + p20["step"] + p22["step"]
         + p23["step"] + p25["step"],
         "max_abs_err": err["step"],
         "ms": timing[1_000_000][0], "plain_ms": timing[1_000_000][1],
         "bound_ms": bytes_ms(STEP_BYTES * 1_000_000), "bound_by": "bytes",
         "library_ms": None},
        {"name": "compact", "route": "cuda",
         "source": src + "raster_compact.cu",
         "replaces": "particle_sim_tpu/render/raster_compact.py:165",
         "launches": launches["compact"] + p20["compact"] + p22["compact"],
         "max_abs_err": err["compact"],
         "ms": cd_timing[1_000_000]["compact"][0],
         "plain_ms": cd_timing[1_000_000]["compact"][1],
         "bound_ms": cd_timing[1_000_000]["compact"][3],
         "bound_by": "bytes",
         "library_ms": cd_timing[1_000_000]["compact"][2]},
        {"name": "deposit", "route": "cuda",
         "source": src + "raster_compact.cu",
         "replaces": "particle_sim_tpu/render/raster_compact.py:85",
         "launches": launches["deposit"] + p20["deposit"] + p22["deposit"],
         "max_abs_err": err["deposit"],
         "ms": cd_timing[1_000_000]["deposit"][0],
         "plain_ms": cd_timing[1_000_000]["deposit"][1],
         "bound_ms": cd_timing[1_000_000]["deposit"][3],
         "bound_by": "bytes",
         "library_ms": cd_timing[1_000_000]["deposit"][2]},
        {"name": "pairwise", "route": "cuda", "source": src + "pairwise.cu",
         "replaces": "particle_sim_tpu/ops/pairwise_pallas.py:54",
         "launches": g_launches["pairwise"] + p20["pairwise"]
         + p22["pairwise"],
         "max_abs_err": err["pairwise"],
         "ms": pw_ms, "plain_ms": pwp_ms, "bound_ms": pw_bound,
         "bound_by": "operations", "library_ms": None},
        # the same template's difference instantiation: pmx's correction,
        # timed on phase 17's buffer (live counts on the device); bound at
        # the members' pairs
        {"name": "pairwise_diff", "route": "cuda",
         "source": src + "pairwise.cu",
         "replaces": "particle_sim_tpu/ops/pairwise_pallas.py:54",
         "launches": pmx_launches["pairwise_diff"] + p20["pairwise_diff"]
         + p22["pairwise_diff"],
         "max_abs_err": err["pairwise_diff"],
         "ms": dk_ms, "plain_ms": dp_ms, "bound_ms": d_flops,
         "bound_by": "operations", "library_ms": None},
        {"name": "sorted_deposit", "route": "cuda",
         "source": src + "raster_sorted.cu",
         "replaces": "particle_sim_tpu/render/raster_sorted.py:47",
         "launches": g_launches["sorted_deposit"]
         + pm_runs["b"][0]["sorted_deposit"] + p22["sorted_deposit"],
         "max_abs_err": err["sorted_deposit"],
         "ms": sd_timing[1_000_000][0], "plain_ms": sd_timing[1_000_000][1],
         "bound_ms": sd_timing[1_000_000][3], "bound_by": "bytes",
         "library_ms": sd_timing[1_000_000][2]},
        # one CUDA template: the unit-mass instantiation replaces :247, the
        # mass one _deposit_kernel_mass (:253); launches of both, phase 12
        {"name": "pm_deposit", "route": "cuda", "source": src + "pm.cu",
         "replaces": "particle_sim_tpu/ops/pm_pallas.py:247",
         "launches": sum(runs[k] for runs in (pm_launches, pmn_launches,
                                              pmx_launches, p19)
                         for k in ("pm_deposit", "pm_deposit_mass"))
         + p20["pm_deposit"] + p22["pm_deposit"] + p22["pm_deposit_mass"]
         + p23["pm_deposit"] + p25["pm_deposit"],
         "max_abs_err": err["pm_deposit"],
         "ms": pm_timing["n=1000000"][0],
         "plain_ms": pm_timing["n=1000000"][1],
         "bound_ms": pm_timing["n=1000000"][3], "bound_by": "bytes",
         "library_ms": pm_timing["n=1000000"][2]},
        {"name": "pm_gather", "route": "cuda", "source": src + "pm.cu",
         "replaces": "particle_sim_tpu/ops/pm_pallas.py:259",
         "launches": pm_launches["pm_gather"] + pmn_launches["pm_gather"]
         + pmx_launches["pm_gather"] + p19["pm_gather"] + p20["pm_gather"]
         + p22["pm_gather"] + p23["pm_gather"] + p25["pm_gather"],
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
         + pm_runs["b"][0]["radix_hist"] + pmx_launches["radix_hist"]
         + p19["radix_hist"] + p20["radix_hist"] + p22["radix_hist"]
         + p23["radix_hist"] + p25["radix_hist"],
         "max_abs_err": err["sort"], "ms": sort_timing["16M"]["hist"],
         "plain_ms": sort_timing["16M"]["hist_plain"],
         "bound_ms": sort_timing["16M"]["hist_bound"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "radix_pass", "route": "cuda",
         "source": src + "radix_sort.cu",
         "replaces": "particle_sim_tpu/ops/psort.py:289",
         "launches": g_launches["radix_pass"]
         + pm_runs["b"][0]["radix_pass"] + pmx_launches["radix_pass"]
         + p19["radix_pass"] + p20["radix_pass"] + p22["radix_pass"]
         + p23["radix_pass"] + p25["radix_pass"],
         "max_abs_err": err["sort"], "ms": sort_timing["16M"]["pass_"],
         "plain_ms": sort_timing["16M"]["pass_plain"],
         "bound_ms": sort_timing["16M"]["pass_bound"], "bound_by": "bytes",
         "library_ms": None},
        # the isolated exact-gradient solve of the kernel path: the pad,
        # product and interleave kernels around four cuFFT plans, one
        # launch a solve; phase 24 at G = 128 on the 16M static-box
        # density; plain: the torch.fft chain it replaced (cuFFT through
        # torch, with its copies)
        {"name": "pm_solve", "route": "cuda", "source": src + "pm_fft.cu",
         "replaces": "particle_sim_tpu/ops/pm.py:370",
         "launches": sum(runs.get("pm_solve", 0) for runs in (
             pm_launches, pmn_launches, pmx_launches, p19, p20, p22, p23,
             p24)),
         "max_abs_err": r24["err"]["n=16777216 static box"],
         "ms": r24["ms"]["n=16777216 static box"][1],
         "plain_ms": r24["ms"]["n=16777216 static box"][0],
         "bound_ms": bytes_ms(pm_fft.solve_bytes(128)), "bound_by": "bytes",
         "library_ms": None},
        # the refinement windows' origins, masks and the exact window's
        # origin and count, one launch a window; phase 26 on the deep-zoom
        # 16M state (two tracked levels); plain: the bookkeeping it
        # replaced (ops/pm2.py _nested_wmins and the masks)
        {"name": "window_pass", "route": "cuda",
         "source": src + "windows.cu",
         "replaces": "particle_sim_tpu/ops/pm2.py:282",
         "launches": sum(runs.get("window_pass", 0) for runs in (
             p19, p20, p22, p23, p25, p26)),
         "max_abs_err": None,
         "ms": r26["ms"]["deep zoom n=16777216"]["pass"],
         "plain_ms": r26["ms"]["deep zoom n=16777216"]["plain"],
         "bound_ms": r26["ms"]["deep zoom n=16777216"]["bound"],
         "bound_by": "bytes", "library_ms": None},
    ]
    print(gpu_name_and_limit())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
