"""Time the candidate designs of the direct all-pairs force
(ops/pairwise_cuda.py:pairwise_accel and pairwise_accel_diff) in turns,
on one card.

    python3 -m particle_sim_tpu_torch.tools.pairwise_variants  # one GPU

Builds ``pairwise_variants.cu`` with nvcc into ``build/pairwise_variants/``,
once a config in ``CONFIGS`` (all nvcc runs started together). The file
holds the earlier kernel, verbatim, as variant 0, and includes the
package's kernel (``csrc/pairwise.cu``), which each config builds with
other values of its numeric -D knobs: receivers a thread (``PW_R``, 2 or
4), threads a block, sources a tile, the sweep's unroll, resident blocks
the registers must allow. Every variant is held to chip_smoke.py phase
6's bar (max |k - p| <= 1e-4 max|p| a component against the plain
``pairwise.pairwise_accel``) on its four cases (65,536 filled-sphere
particles, G = 1, eps 0.5: the square, 60,000 active with poisoned
padding, a central mass of 1000, 65,536 x 32,768 at j_base 32,768), and
the difference pass to phase 17's (within 2e-4 max|a_x| of the two plain
passes subtracted) on pmx's buffer at 1M (phase 17's scene: 47,272-odd
members of a capacity of 65,536, live counts on the device); a variant
that misses a bar is timed and marked, and the package's design or
variant 0 missing one exits 1. Then CUDA-event medians, in turns: at
65,536^2 every variant against variant 0, and on pmx's buffer each
variant's difference pass against two variant-0 passes over the whole
capacity (what pmx ran before); then the package's design at several
source splits (``pairwise_cuda.BLOCKS_PER_SM``). Prints each variant's
registers, blocks an SM, spills and the SASS mix a pair of its hot loop.
The numbers also go to ``build/pairwise_variants/report.json``. Exits 1
without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
BUILD = ROOT / "build" / "pairwise_variants"
#: builds of pairwise_variants.cu: (name, -D flags); the first is the
#: package's own settings and holds variant 0
CONFIGS = (
    ("the package's design", {}),
    ("R = 2", {"PW_R": 2}),
    ("R = 2, 256 threads", {"PW_R": 2, "PW_THREADS": 256}),
    ("R = 4, 64 threads", {"PW_THREADS": 64}),
    ("R = 4, 6 blocks an SM at least", {"PW_MIN_BLOCKS": 6}),
    ("R = 4, unroll 8", {"PW_UNROLL": 8}),
    ("R = 4, unroll 4", {"PW_UNROLL": 4}),
    ("R = 4, 512-source tiles", {"PW_TJ": 512}),
)
#: source splits timed with the package's design: BLOCKS_PER_SM targets
SPLIT_TARGETS = (4, 8, 12, 16, 24, 32)
G_CONST, EPS = 1.0, 0.5
#: phase 17's pmx scene: softenings of the window and of the mesh below it
EPS_X, EPS_PREV = 0.5, 2.0


def start_builds(configs=CONFIGS) -> list:
    """Start one nvcc a config. -> [(name, library path, process)]."""
    from particle_sim_tpu_torch.utils import cuda_build

    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for c, (name, flags) in enumerate(configs):
        out = BUILD / f"libpairwise_variants{c}.so"
        defs = [f"-D{k}={v}" for k, v in flags.items()]
        jobs.append((name, out, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *defs, "-shared",
             "-o", str(out), str(HERE / "pairwise_variants.cu")],
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
        for ln in text.splitlines():
            if "arning" in ln:
                print(f"  ptxas ({name}): {ln.strip()}")
        libs.append((load(out), out))
    return libs


def load(path) -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(str(path))
    sig = {"psim_pairwise": (P, P, P, P, P, P, P, P, I, I, I, I, P),
           "probe_pkg_occupancy": (I, P),
           "probe_v0_pairwise": (P, P, P, P, P, I, I, P),
           "probe_v0_occupancy": (P,)}
    for fn, argtypes in sig.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


#: SASS names (a substring of the mangled name) of each kernel
SASS_NAMES = {"pkg": "pairwise_kernelILb0", "diff": "pairwise_kernelILb1",
              "v0": "2v015pairwise_kernel"}


def occupancy(lib, kind: str = "pkg") -> dict:
    """Registers, shared bytes, blocks an SM, threads, spill bytes,
    receivers a block and a thread, sources a tile of one kernel ("pkg",
    "diff" or "v0") of a variant's library on the current device."""
    info = (ctypes.c_int * 8)()
    ptr = ctypes.cast(info, ctypes.c_void_p)
    err = (lib.probe_v0_occupancy(ptr) if kind == "v0"
           else lib.probe_pkg_occupancy(int(kind == "diff"), ptr))
    if err:
        raise RuntimeError(f"occupancy query: CUDA error {err}")
    return dict(zip(("registers", "shared_bytes", "blocks_per_sm", "threads",
                     "local_bytes", "receivers_per_block",
                     "receivers_per_thread", "tile"), info))


class Inputs:
    """One call's operands as the package's wrapper prepares them:
    receivers f32[Ni, 3], source planes f32[3, Nj], gv, eps^2 (one, or two
    for the difference pass) and the live counts (int32 on the device, or
    None)."""

    def __init__(self, xi, xj, n_active, softenings, *, j_base=0,
                 masses=None, n_i=None, n_j=None):
        import torch

        from particle_sim_tpu_torch.ops import pairwise

        dev = xi.device
        self.xi, self.xj = xi.contiguous(), xj.contiguous()
        self.ni, self.nj = self.xi.shape[0], self.xj.shape[1]
        self.gv = pairwise.source_weights(self.nj, n_active, G_CONST,
                                          j_base=j_base, masses=masses,
                                          device=dev).contiguous()
        self.eps_sq = torch.tensor([e * e for e in softenings],
                                   dtype=torch.float32, device=dev)
        self.n_i, self.n_j = n_i, n_j


def kernel_call(lib, inp: Inputs, slices: int, out=None, part=None):
    """One call of a variant's package kernel (the difference pass when
    ``inp`` has two softenings) with ``slices`` source slices.
    -> f32[Ni, 3]."""
    import torch

    dev = inp.xi.device
    if out is None:
        out = torch.empty((inp.ni, 3), dtype=torch.float32, device=dev)
    if slices > 1 and part is None:
        part = torch.empty((slices, inp.ni, 3), dtype=torch.float32,
                           device=dev)
    ptr = [None if t is None else t.data_ptr()
           for t in (inp.n_i, inp.n_j, part)]
    err = lib.psim_pairwise(inp.xi.data_ptr(), inp.xj.data_ptr(),
                            inp.gv.data_ptr(), inp.eps_sq.data_ptr(), ptr[0],
                            ptr[1], out.data_ptr(), ptr[2], inp.ni, inp.nj,
                            slices, int(inp.eps_sq.numel() == 2),
                            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pairwise variant: CUDA error {err}")
    return out


def v0_call(lib, inp: Inputs, out=None, eps_k: int = 0):
    """One launch of variant 0 (the earlier kernel: every source, no live
    counts) at softening ``inp``'s ``eps_k``-th. -> f32[Ni, 3]."""
    import torch

    if out is None:
        out = torch.empty((inp.ni, 3), dtype=torch.float32,
                          device=inp.xi.device)
    err = lib.probe_v0_pairwise(
        inp.xi.data_ptr(), inp.xj.data_ptr(), inp.gv.data_ptr(),
        inp.eps_sq[eps_k:].data_ptr(), out.data_ptr(), inp.ni, inp.nj,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pairwise variant 0: CUDA error {err}")
    return out


def slices_for(lib, inp: Inputs, blocks_per_sm=None) -> int:
    """The wrapper's source split (pairwise_cuda.source_slices) for this
    variant's block shape, at ``blocks_per_sm`` (default the package's
    BLOCKS_PER_SM)."""
    from particle_sim_tpu_torch.ops import pairwise_cuda

    info = occupancy(lib, "diff" if inp.eps_sq.numel() == 2 else "pkg")
    return pairwise_cuda._split(
        inp.ni, inp.nj, pairwise_cuda.sm_count(inp.xi.device.index),
        blocks_per_sm or pairwise_cuda.BLOCKS_PER_SM,
        info["receivers_per_block"], info["tile"])


def phase6_cases(x):
    """chip_smoke.py phase 6's four cases on the filled sphere x (f32[3,
    65,536]): (label, receivers f32[Ni, 3], sources, n_active, kwargs)."""
    import torch

    n = x.shape[1]
    half = n // 2
    poisoned = x.clone()
    poisoned[:, 60_000:] = 1e3
    masses = torch.ones(n, dtype=torch.float32, device=x.device)
    masses[0] = 1000.0
    return [("square", x.T, x, n, {}),
            ("60000 active, poisoned padding", poisoned.T, poisoned, 60_000,
             {}),
            ("central mass 1000", x.T, x, n, {"masses": masses}),
            ("65536 x 32768, j_base 32768", x.T, x[:, half:].contiguous(),
             n, {"j_base": half})]


def pmx_buffer(dev, n: int = 1_048_576, capacity: int = 65_536):
    """chip_smoke.py phase 17's pmx buffer: 1M uniform in [-45, 45]^3
    (seed 7), a tracked window of 32 at eps 0.5, capacity 65,536; the
    members first, then other slots. -> (rec f32[B, 3], src f32[3, B],
    in-budget masses f32[B], in-budget count int32 0-d on the device)."""
    import torch

    from particle_sim_tpu_torch.ops import pm, pm2, pmx

    g = torch.Generator(device=dev).manual_seed(7)
    pos = (torch.rand((3, n), generator=g, device=dev) * 90.0
           - 45.0).contiguous()
    live = pm.live_mask(n, torch.tensor(n, dtype=torch.int32, device=dev),
                        dev)
    cfgx = pmx.PMXConfig(window_size=32.0, softening=EPS_X,
                         capacity=capacity)
    wmin = pm2.window_min(pos, None, cfgx, None, live=live)
    member = pmx._member_mask(pos, wmin, cfgx, live)
    n_in = torch.clamp_max(member.sum(dtype=torch.int32), capacity)
    idx = pmx.members_first(member)[:capacity].long()
    buf = pos.index_select(1, idx)
    m_buf = (torch.arange(capacity, device=dev) < n_in).float()
    return buf.T.contiguous(), buf, m_buf, n_in


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pairwise_variants: needs an NVIDIA GPU "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import numpy as np

    from particle_sim_tpu_torch.core import generate as gen
    from particle_sim_tpu_torch.ops import pairwise
    from particle_sim_tpu_torch.utils import cuda_build

    sys.path.insert(0, str(ROOT))
    from chip_smoke import (
        FP32_FLOPS_PER_S, PAIR_FLOPS, clocks_under_load, gpu_name_and_limit,
        median_ms, mix_per_pair, sass_mix,
    )

    dev = torch.device("cuda", 0)
    card = gpu_name_and_limit()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    jobs = start_builds()
    cuda_build.library()
    libs = finish_builds(jobs)
    lib0 = libs[0][0]
    report = {"device": torch.cuda.get_device_name(0), "card": card,
              "variants": {}}

    # -- the bars: phase 6's four cases, phase 17's difference ------------
    gpos, _, _ = gen.generate(65_536, gen.SphereGeneration.FILLED)
    x = torch.from_numpy(np.ascontiguousarray(gpos.T)).to(dev)
    errs = {name: [] for name, _ in CONFIGS}
    errs["v0"] = []
    for label, xi, xj, na, kw in phase6_cases(x):
        want = pairwise.pairwise_accel(xi, xj, na, G_CONST, EPS, **kw)
        scale = want.abs().amax(0)
        inp = Inputs(xi, xj, na, (EPS,), **kw)
        for name, (lib, _) in [("v0", libs[0])] + [
                (nm, lb) for (nm, _), lb in zip(CONFIGS, libs)]:
            got = (v0_call(lib, inp) if name == "v0"
                   else kernel_call(lib, inp, slices_for(lib, inp)))
            torch.cuda.synchronize()
            rel = (float(((got - want).abs().amax(0) / scale).max())
                   if torch.isfinite(got).all() else float("inf"))
            errs[name].append((label, rel, 1e-4))
    rec, src, m_buf, n_in = pmx_buffer(dev)
    b = src.shape[1]
    a_x = pairwise.pairwise_accel(rec, src, b, G_CONST, EPS_X, masses=m_buf)
    want = a_x - pairwise.pairwise_accel(rec, src, b, G_CONST, EPS_PREV,
                                         masses=m_buf)
    # pmx keeps the members' rows; the kernel's receivers past n_in get 0
    want = torch.where((torch.arange(b, device=dev) < n_in)[:, None], want,
                       0.0)
    sx = float(a_x.abs().max())
    d_inp = Inputs(rec, src, b, (EPS_X, EPS_PREV), masses=m_buf, n_i=n_in,
                   n_j=n_in)
    v_inp = Inputs(rec, src, b, (EPS_X, EPS_PREV), masses=m_buf)
    for name, (lib, _) in zip((nm for nm, _ in CONFIGS), libs):
        got = kernel_call(lib, d_inp, slices_for(lib, d_inp))
        torch.cuda.synchronize()
        errs[name].append(("pmx difference pass", float(
            (got - want).abs().max()) / sx if torch.isfinite(got).all()
            else float("inf"), 2e-4))
    got = torch.where((torch.arange(b, device=dev) < n_in)[:, None],
                      v0_call(lib0, v_inp) - v0_call(lib0, v_inp, eps_k=1),
                      0.0)
    errs["v0"].append(("pmx two passes",
                       float((got - want).abs().max()) / sx, 2e-4))
    failed = {name for name, rows in errs.items()
              if any(not e <= bar for _, e, bar in rows)}
    print(f"{len(errs) - len(failed)} of {len(errs)} variants within "
          f"phase 6's and phase 17's bars"
          + (f"; missing a bar (timed, not eligible): {sorted(failed)}"
             if failed else ""))

    # -- times in turns ---------------------------------------------------
    n_mem = int(n_in)
    pairs, pmx_pairs = 65_536.0 ** 2, float(n_mem) ** 2
    sq = Inputs(x.T, x, 65_536, (EPS,))
    fns = [lambda: v0_call(lib0, sq)]
    fns += [lambda lib=lib: kernel_call(lib, sq, slices_for(lib, sq))
            for lib, _ in libs]
    sq_ms = median_ms(fns, reps=7, inner=5, lead_ms=5 * 4.0)
    fns = [lambda: (v0_call(lib0, v_inp), v0_call(lib0, v_inp, eps_k=1))]
    fns += [lambda lib=lib: kernel_call(lib, d_inp, slices_for(lib, d_inp))
            for lib, _ in libs]
    pmx_ms = median_ms(fns, reps=7, inner=5, lead_ms=5 * 6.0)
    flops_ms = PAIR_FLOPS * pairs / FP32_FLOPS_PER_S * 1e3
    rows = [("v0", lib0, libs[0][1], "v0", sq_ms[0], pmx_ms[0])]
    rows += [(name, lib, path, "pkg", s, p) for (name, _), (lib, path), s, p
             in zip(CONFIGS, libs, sq_ms[1:], pmx_ms[1:])]
    for name, lib, path, kind, s_ms, p_ms in rows:
        occ = occupancy(lib, kind)
        s_sq = slices_for(lib, sq) if kind == "pkg" else 1
        how = ("two passes over the capacity" if kind == "v0"
               else "one difference pass")
        mix = sass_mix(path, SASS_NAMES[kind])
        extra = ""
        if kind == "pkg":
            docc = occupancy(lib, "diff")
            dmix = sass_mix(path, SASS_NAMES["diff"])
            extra = (f"; the difference pass: {docc['registers']} registers,"
                     f" {docc['blocks_per_sm']} blocks an SM, "
                     f"{docc['local_bytes']} B local, a pair: "
                     f"{mix_per_pair(dmix, rsq_per_pair=2)}, S "
                     f"{slices_for(lib, d_inp)}")
        print(f"{'[MISSES A BAR] ' if name in failed else ''}{name}: "
              f"65536^2 {s_ms:.4f} ms ({flops_ms / s_ms:.1%} of the flops "
              f"bound {flops_ms:.4f} ms), S {s_sq}; pmx correction "
              f"({n_mem} members) {p_ms:.4f} ms ({how}); "
              f"{occ['registers']} registers, {occ['blocks_per_sm']} blocks "
              f"of {occ['threads']} threads an SM, R "
              f"{occ['receivers_per_thread']}, {occ['local_bytes']} B local, "
              f"{occ['shared_bytes']} B "
              f"shared; a pair: {mix_per_pair(mix)}{extra}")
        for label, e, bar in errs[name]:
            print(f"    {label}: max |k - p| {e:.4g} of the scale (bar "
                  f"{bar:g})")
        report["variants"][name] = {
            "ms_65536": s_ms, "ms_pmx": p_ms, "within_bars":
            name not in failed, "occupancy": occ, "sass": mix,
            "errors": [{"case": label, "rel": e, "bar": bar}
                       for label, e, bar in errs[name]]}

    # -- the source split of the package's design -------------------------
    fns, labels = [], []
    for t in SPLIT_TARGETS:
        for inp, what in ((sq, "65536^2"), (d_inp, "pmx")):
            s = slices_for(lib0, inp, t)
            fns.append(lambda inp=inp, s=s: kernel_call(lib0, inp, s))
            labels.append(f"{what} target {t} blocks an SM (S {s})")
    split_ms = median_ms(fns, reps=5, inner=5, lead_ms=5 * 4.0)
    print("source split, the package's design: " + " | ".join(
        f"{lb} {t:.4f} ms" for lb, t in zip(labels, split_ms)))
    report["split_ms"] = dict(zip(labels, split_ms))
    clk = clocks_under_load(lambda: kernel_call(lib0, sq, slices_for(lib0,
                                                                   sq)))
    print(f"the package's design at 65536^2 back to back: {clk}")
    report["clocks_under_load"] = clk
    report["pmx_members"] = n_mem
    report["pmx_pairs"] = pmx_pairs
    (BUILD / "report.json").write_text(json.dumps(report, indent=1))
    print(card)
    if CONFIGS[0][0] in failed or "v0" in failed:
        print("the package's design or variant 0 misses a bar",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
