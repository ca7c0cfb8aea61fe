"""Time the candidate designs of the tensor-core all-pairs force
(ops/pairwise_cuda.py:pairwise_accel_mxu) in turns, on one card.

    python3 -m particle_sim_tpu_torch.tools.pairwise_mxu_variants  # repo root, one GPU

Builds ``pairwise_mxu_variants.cu`` with nvcc into
``build/pairwise_mxu_variants/``, once a config in ``CONFIGS`` (all nvcc
runs started together). The file holds the earlier kernel, verbatim, as
variant 0, and includes the package's kernel (``csrc/pairwise_mxu.cu``),
which each config builds with other values of its numeric -D knobs (the
chain length of product 2's accumulator, the unroll, warps and row tiles
a block, sources a stage, blocks an SM), and variant (e), product 1 on
``wgmma``, as a kernel of its own. The other designs tried on the way to
the package's (PERF.md section 6 keeps their numbers) are not kept. On
phase 14 of chip_smoke.py's five cases (65,536 filled-sphere particles,
G = 2.5, eps 0.5: the square, 60,000 active with poisoned padding, 65,536
x 32,768 at j_base 32,768, 32,768 x 65,536, 1,000 x 777 with 700 active)
it holds every variant to phase 14's two bars before it times any (a
variant that misses one is timed and marked, not eligible; the
package's design or variant 0 missing one exits 1):
within twice the plain version's (``pairwise.pairwise_accel_mxu_ref``)
own distance from the direct sum, and max |dA| / (|A| + 1e-2) < 0.05 a
component against the direct kernel (``pairwise_cuda.pairwise_accel``).
Then CUDA-event medians at 65,536^2 of every variant's kernel alone (the
new ones read their receivers through the Hilbert order, variant 0 takes
them gathered), in turns, and of the whole function: the package's
``pairwise_accel_mxu`` against the earlier path (plain ``hilbert_order``,
a gather, variant 0, ``index_copy_``). Prints each variant's registers,
blocks an SM, spills and the SASS mix a pair of its hot loop. The numbers
also go to ``build/pairwise_mxu_variants/report.json``. Exits 1 without
CUDA.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
BUILD = ROOT / "build" / "pairwise_mxu_variants"
_ONE = {"MXU_MTILES": 1}         # one row tile a warp (128 receivers)
#: builds of pairwise_mxu_variants.cu: (name, -D flags); the first is the
#: package's own settings and holds variant 0
CONFIGS = (
    ("the package's design: (a)-(d), 2 row tiles a warp", {}),
    ("(c) chains of 8 steps", {"MXU_ACC_CHAIN": 8}),
    ("(c) chains of 16 steps", {"MXU_ACC_CHAIN": 16}),
    ("(d) unroll 2 chain pairs", {"MXU_UNROLL": 2}),
    ("(d) 4 warps a block (128 receivers)", {"MXU_WARPS": 4}),
    ("(d) 128 sources a stage", {"MXU_TJ": 128}),
    ("(d) one row tile a warp", _ONE),
    ("(d) one row tile a warp, at least 3 blocks an SM",
     dict(_ONE, MXU_MIN_BLOCKS=3)),
    # variant (e): its own kernel in pairwise_mxu_variants.cu
    ("(e) product 1 on wgmma (m64n32k8, K = 16, B from shared memory, two "
     "chunks in flight, 2 stage buffers), product 2 on mma.sync (chains of "
     "8 steps, two accumulators), one row tile a warp",
     {"MXU_WG": 1, "MXU_MTILES": 1}),
)
G_CONST, EPS = 2.5, 0.5


def start_builds(configs=CONFIGS) -> list:
    """Start one nvcc a config. -> [(name, library path, process)]."""
    from particle_sim_tpu_torch.utils import cuda_build

    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for c, (name, flags) in enumerate(configs):
        out = BUILD / f"libpairwise_mxu_variants{c}.so"
        defs = [f"-D{k}={v}" for k, v in flags.items()]
        jobs.append((name, out, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *defs, "-shared",
             "-o", str(out), str(HERE / "pairwise_mxu_variants.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return jobs


def finish_builds(jobs) -> list:
    """Wait for the builds and load them. -> [(ctypes.CDLL, path)] a
    config."""
    libs = []
    for name, out, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({name}):\n{text}")
        for ln in text.splitlines():    # ptxas' warnings (wgmma serialised)
            if "arning" in ln or "Performance" in ln:
                print(f"  ptxas ({name}): {ln.strip()}")
        libs.append((load(out), out))
    return libs


def load(path) -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(str(path))
    sig = {"psim_pairwise_mxu": (P, P, P, P, P, P, P, I, I, P),
           "psim_pairwise_mxu_occupancy": (P,),
           "probe_v0_mxu": (P, P, P, P, P, P, I, I, P),
           "probe_v0_occupancy": (P,),
           "probe_wg_mxu": (P, P, P, P, P, P, P, I, I, P),
           "probe_wg_occupancy": (P,),
           "probe_rate": (I, I, I, P, P)}
    for fn, argtypes in sig.items():
        if hasattr(lib, fn):            # probe_wg_*: MXU_WG builds only
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


#: a variant's exports by kind: (launcher, occupancy query, SASS name)
KINDS = {"pkg": ("psim_pairwise_mxu", "psim_pairwise_mxu_occupancy",
                 "pairwise_mxu_kernel"),
         "v0": ("probe_v0_mxu", "probe_v0_occupancy", "2v0"),
         "wg": ("probe_wg_mxu", "probe_wg_occupancy", "wg_kernel")}


def occupancy(lib, kind: str = "pkg") -> dict:
    """Registers, shared bytes, blocks an SM, threads, spill bytes and
    receivers a block of a variant's kernel on the current device."""
    info = (ctypes.c_int * 6)()
    fn = getattr(lib, KINDS[kind][1])
    err = fn(ctypes.cast(info, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"occupancy query: CUDA error {err}")
    return dict(zip(("registers", "shared_bytes", "blocks_per_sm",
                     "threads", "local_bytes", "receivers_per_block"), info))


class Inputs:
    """One call's operands as the package's wrapper prepares them: the
    receivers' Hilbert order (key kernel + radix sort), the inlier box,
    gv and eps^2; ``xi_sorted`` (the receivers gathered in that order) for
    variant 0."""

    def __init__(self, pos, src, n_active, j_base=0):
        import torch

        from particle_sim_tpu_torch.ops import pairwise, pairwise_cuda

        dev = pos.device
        self.pos, self.src = pos.contiguous(), src.contiguous()
        self.ni, self.nj = pos.shape[1], src.shape[1]
        self.order = pairwise_cuda.receiver_order(pos)
        self.xi_sorted = pos[:, self.order.long()].contiguous()
        self.box = pairwise_cuda.inlier_box(pos)
        self.gv = pairwise.source_weights(self.nj, n_active, G_CONST,
                                          j_base=j_base, device=dev)
        self.eps_sq = torch.full((1,), EPS * EPS, dtype=torch.float32,
                                 device=dev)


def kernel_call(lib, inp: Inputs, out=None, kind: str = "pkg"):
    """One launch of a new variant's kernel (kind "pkg" or "wg").
    -> f32[3, ni], own order."""
    import torch

    if out is None:
        out = torch.empty((3, inp.ni), dtype=torch.float32,
                          device=inp.pos.device)
    err = getattr(lib, KINDS[kind][0])(
        inp.pos.data_ptr(), inp.order.data_ptr(), inp.src.data_ptr(),
        inp.gv.data_ptr(), inp.eps_sq.data_ptr(), inp.box.data_ptr(),
        out.data_ptr(), inp.ni, inp.nj,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pairwise_mxu variant: CUDA error {err}")
    return out


def v0_call(lib, inp: Inputs, out=None):
    """One launch of variant 0 on the pre-gathered receivers.
    -> f32[3, ni] in Hilbert order."""
    import torch

    if out is None:
        out = torch.empty((3, inp.ni), dtype=torch.float32,
                          device=inp.pos.device)
    err = lib.probe_v0_mxu(
        inp.xi_sorted.data_ptr(), inp.src.data_ptr(), inp.gv.data_ptr(),
        inp.eps_sq.data_ptr(), inp.box.data_ptr(), out.data_ptr(), inp.ni,
        inp.nj, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pairwise_mxu variant 0: CUDA error {err}")
    return out


def earlier_path(lib, pos, src, n_active, g_const, softening, j_base=0):
    """The whole function as it was before the redesign: plain
    ``hilbert_order`` (torch ops and an argsort), a gather of the
    receivers, variant 0, ``index_copy_`` back. -> f32[3, ni]."""
    import torch

    from particle_sim_tpu_torch.ops import pairwise, pairwise_cuda

    dev = pos.device
    n_i, n_j = pos.shape[1], src.shape[1]
    order = pairwise_cuda.hilbert_order(pos)
    xi = pos[:, order].contiguous()
    xj = src.contiguous()
    box = pairwise_cuda.inlier_box(pos)
    gv = pairwise.source_weights(n_j, n_active, g_const, j_base=j_base,
                                 device=dev).contiguous()
    eps = torch.as_tensor(softening, dtype=torch.float32, device=dev)
    eps_sq = (eps * eps).reshape(1)
    out = torch.empty((3, n_i), dtype=torch.float32, device=dev)
    err = lib.probe_v0_mxu(xi.data_ptr(), xj.data_ptr(), gv.data_ptr(),
                           eps_sq.data_ptr(), box.data_ptr(), out.data_ptr(),
                           n_i, n_j, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pairwise_mxu variant 0: CUDA error {err}")
    return torch.empty_like(out).index_copy_(1, order, out)


def pipe_rates(lib, pairs: float) -> dict:
    """Throughput of the sweep's pipes on this card (probe_rate: every
    warp runs 8 independent chains of one instruction or sequence, 64
    warps an SM): mma.sync TF32 m16n8k8 and m16n8k4, MUFU rsqrt, the 1:1
    mix of m16n8k8 and rsqrt that the sweep issues (4 of each a 16 x 8
    tile, 128 pairs), a pair's FP32 chain (rsqrt, cube, W's split) alone
    and with one m16n8k8, in warp instructions (or chains) a clock an SM
    at clocks.max.sm. -> {name: rate}, and the time each of the three
    mixes puts on ``pairs`` pairs ("... ms")."""
    import torch

    from chip_smoke import median_ms, nvidia_smi

    clk = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    out = torch.zeros(256, dtype=torch.float32, device="cuda")
    blocks, iters = 132 * 8, 2048
    stream = torch.cuda.current_stream().cuda_stream
    names = ("mma m16n8k8 tf32", "mma m16n8k4 tf32", "rsqrt",
             "mix: mma m16n8k8 + rsqrt", "a pair's chain: rsqrt, cube, split",
             "the chain + mma m16n8k8")
    ms = median_ms([lambda k=k: lib.probe_rate(k, blocks, iters,
                                               out.data_ptr(), stream)
                    for k in range(len(names))], reps=5, inner=3)
    warp_instr = blocks * 8 * iters * 8
    rates = {n: warp_instr / (t * 1e-3) / 132 / clk for n, t in zip(names, ms)}
    # one warp instruction (or chain) of the mix a 32 pairs
    for n in names[3:]:
        rates[n + " ms"] = pairs / 32 / (rates[n] * 132 * clk) * 1e3
    rates["clock_mhz"] = clk / 1e6
    return rates


def phase14_cases(x):
    """chip_smoke.py phase 14's five cases on the filled sphere x
    (f32[3, 65,536]): (label, receivers, sources, n_active, j_base)."""
    n = x.shape[1]
    half = n // 2
    poisoned = x.clone()
    poisoned[:, 60_000:] = 1e3
    return [("square", x, x, n, 0),
            ("60000 active, poisoned padding", poisoned, poisoned, 60_000, 0),
            ("65536 x 32768, j_base 32768", x, x[:, half:].contiguous(), n,
             half),
            ("32768 x 65536", x[:, :half].contiguous(), x, n, 0),
            ("1000 x 777, 700 active", x[:, :1000].contiguous(),
             x[:, :777].contiguous(), 700, 0)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pairwise_mxu_variants: needs an NVIDIA GPU "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import numpy as np

    from particle_sim_tpu_torch.core import generate as gen
    from particle_sim_tpu_torch.ops import pairwise, pairwise_cuda
    from particle_sim_tpu_torch.utils import cuda_build

    sys.path.insert(0, str(ROOT))
    from chip_smoke import (
        RSQRT_PER_S, gpu_name_and_limit, median_ms, mix_per_pair, sass_mix,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_name_and_limit()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    jobs = start_builds()
    cuda_build.library()
    libs = finish_builds(jobs)
    # (name, lib, path, kind)
    variants = [("v0 earlier: K = 3 + 5 FP32 adds, bit-split W, FP32 stage "
                 "sum, one buffer", libs[0][0], libs[0][1], "v0")]
    variants += [(name, lib, path, "wg" if "MXU_WG" in flags else "pkg")
                 for (name, flags), (lib, path) in zip(CONFIGS, libs)]

    gpos, _, _ = gen.generate(65_536, gen.SphereGeneration.FILLED)
    x = torch.from_numpy(np.ascontiguousarray(gpos.T)).to(dev)
    report = {"device": torch.cuda.get_device_name(0), "card": card,
              "variants": {}}
    errs = {name: [] for name, *_ in variants}
    for label, xi_, xj_, na, jb in phase14_cases(x):
        inp = Inputs(xi_, xj_, na, jb)
        want = pairwise.pairwise_accel_mxu_ref(xi_, xj_, na, G_CONST, EPS,
                                               j_base=jb)
        direct = pairwise_cuda.pairwise_accel(xi_.T, xj_, na, G_CONST, EPS,
                                              j_base=jb).T
        bar = 2.0 * float((want - direct).abs().max())
        for name, lib, _, kind in variants:
            if kind == "v0":
                got = torch.empty_like(want).index_copy_(
                    1, inp.order.long(), v0_call(lib, inp))
            else:
                got = kernel_call(lib, inp, kind=kind)
            torch.cuda.synchronize()
            e = (float((got - want).abs().max())
                 if torch.isfinite(got).all() else float("inf"))
            rel = float(((got - direct).abs()
                         / (direct.abs() + 1e-2)).max())
            errs[name].append((label, e, bar, rel))
    failed = {name for name, rows in errs.items()
              if any(not (e <= bar and rel < 0.05) for _, e, bar, rel in rows)}
    print(f"{len(variants) - len(failed)} of {len(variants)} variants "
          f"within both bars in all five cases"
          + (f"; missing a bar (timed, not eligible): {sorted(failed)}"
             if failed else ""))

    inp = Inputs(x, x, 65_536)
    pairs = 65_536.0 ** 2
    rsqrt_ms = pairs / RSQRT_PER_S * 1e3
    fns = [(lambda lib=lib, kind=kind: v0_call(lib, inp) if kind == "v0"
            else kernel_call(lib, inp, kind=kind))
           for _, lib, _, kind in variants]
    ms = median_ms(fns, reps=7, inner=5, lead_ms=5 * 5.0)
    for (name, lib, path, kind), t in zip(variants, ms):
        occ = occupancy(lib, kind)
        mix = sass_mix(path, KINDS[kind][2],
                       **({"skip": "2v0"} if kind == "pkg" else {}))
        worst = max(r for *_, r in errs[name])
        print(f"{'[MISSES A BAR] ' if name in failed else ''}{name}: "
              f"{t:.4f} ms ({rsqrt_ms / t:.1%} of the rsqrt bound "
              f"{rsqrt_ms:.4f} ms); max |dA| / (|A| + 1e-2) {worst:.4g} "
              f"against the direct kernel; {occ['registers']} registers, "
              f"{occ['blocks_per_sm']} blocks of {occ['threads']} threads an "
              f"SM, {occ['local_bytes']} B local, {occ['shared_bytes']} B "
              f"shared; a pair: {mix_per_pair(mix)}")
        for label, e, bar, rel in errs[name]:
            print(f"    {label}: max |k - p| {e:.4g} (bar {bar:.4g}), "
                  f"max |dA| / (|A| + 1e-2) {rel:.4g}")
        report["variants"][name] = {
            "ms": t, "within_bars": name not in failed, "occupancy": occ,
            "sass": mix,
            "errors": [{"case": label, "max_abs_vs_plain": e, "bar": bar,
                        "max_rel_vs_direct": rel}
                       for label, e, bar, rel in errs[name]]}

    rates = pipe_rates(libs[0][0], pairs)
    print(f"pipe rates at clocks.max.sm {rates['clock_mhz']:.0f} MHz, warp "
          f"instructions (or chains) a clock an SM: " + ", ".join(
              f"{k} {v:.4g}" for k, v in rates.items()
              if not k.endswith("ms") and k != "clock_mhz")
          + "; one of each a 32 pairs takes at 65536^2: " + ", ".join(
              f"{k[:-3]} {v:.4f} ms" for k, v in rates.items()
              if k.endswith(" ms")))
    report["pipe_rates"] = rates

    # the whole function: the package's wrapper against the earlier path
    lib0 = libs[0][0]
    whole = median_ms(
        [lambda: earlier_path(lib0, x, x, 65_536, G_CONST, EPS),
         lambda: pairwise_cuda.pairwise_accel_mxu(x, x, 65_536, G_CONST, EPS),
         lambda: pairwise_cuda.pairwise_accel_mxu(x, x, 65_536, G_CONST, EPS),
         lambda: earlier_path(lib0, x, x, 65_536, G_CONST, EPS)],
        reps=7, inner=5, lead_ms=5 * 8.0)
    print(f"whole function 65536^2 (in turns: earlier, new, new, earlier): "
          f"{' | '.join(f'{t:.4f}' for t in whole)} ms")
    report["whole_ms"] = {"earlier": [whole[0], whole[3]],
                          "new": [whole[1], whole[2]]}
    (BUILD / "report.json").write_text(json.dumps(report, indent=1))
    print(card)
    if CONFIGS[0][0] in failed or variants[0][0] in failed:
        print("the package's design or variant 0 misses a bar",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
