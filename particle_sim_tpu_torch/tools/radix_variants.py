"""Time the candidate designs of the radix sort in turns, on one card, on
the words the repo sorts.

    python3 -m particle_sim_tpu_torch.tools.radix_variants  # repo root, one GPU

Builds ``radix_variants.cu`` (which includes ``csrc/radix_sort.cu``) with
nvcc into ``build/radix_variants/``, once a config, and on five inputs (the PM
forward-sort words, int32 cell key at G = 128, index and packed
fractions, of 1M and 16,777,216 hollow-sphere particles; the sorted
renderer's tile keys with their r, g, b of 1M @ 1280x720 and 16M @
1920x1080; random uint32 keys with three payloads at 16M) checks every
variant word for word against the plain version (``psort.radix_sort_ref``)
and prints CUDA-event medians of:

  * 8-bit digits, payloads carried through every pass (``psort.sort``, the
    design on the path), and the same kernels built with other tile
    sizes, occupancy bounds and look-back windows (``CONFIGS``, -D flags
    of csrc/radix_sort.cu, one build each);
  * the same with a pass kernel that copies each tile's payload words into
    shared memory by cp.async while its keys are ranked (v1);
  * 11-bit digits, payloads carried;
  * 8-bit and 11-bit digits sorting (key, index), then one gather of the
    payloads by the sorted index (the index made by ``torch.arange``
    beforehand; its time is printed apart);
  * the merge sort (``psort.merge_sort``), ``torch.sort(key)`` +
    ``index_select`` of every payload, and the histogram alone;

beside the bytes bound of the design on the path (one read of the keys,
2 x 4 x words x n a pass taken). Prints each kernel's registers and
shared memory (``ptxas -v``). The numbers also go to
``build/radix_variants/report.json``. Exits 1 without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
BUILD = ROOT / "build" / "radix_variants"
#: builds of radix_variants.cu: (name, -D flags of csrc/radix_sort.cu);
#: the first is the package's own settings
CONFIGS = (("the package's settings", {}),
           ("look-back window 4", {"RS_LOOKBACK": 4}),
           ("look-back window 8", {"RS_LOOKBACK": 8}),
           ("look-back window 16", {"RS_LOOKBACK": 16}),
           ("3 blocks an SM (__launch_bounds__(256, 3))",
            {"RS_MIN_BLOCKS": 3}),
           ("2 blocks an SM (__launch_bounds__(256, 2))",
            {"RS_MIN_BLOCKS": 2}),
           ("tiles of 2,048 (8 keys a thread)", {"RS_ITEMS": 8}),
           ("histogram with a one-value warp test (one atomic of 32)",
            {"RS_HIST_UNIFORM": 1}),
           ("histogram at most 2 blocks an SM", {"RS_HIST_BLOCKS": 2}),
           ("histogram at most 8 blocks an SM", {"RS_HIST_BLOCKS": 8}))
#: (name, digit bits, via a sorted index, pass kernel: 0 the package's, 1
#: the prefetching one, config index); bits None: psort.sort itself
VARIANTS = ((("8-bit, payloads carried (psort.sort)", None, False, 0, 0),)
            + tuple((f"8-bit, payloads carried, {name}", 8, False, 0, c)
                    for c, (name, _) in enumerate(CONFIGS))
            + (("8-bit, payloads carried, v1: prefetched into shared memory "
                "by cp.async", 8, False, 1, 0),
               ("11-bit, payloads carried", 11, False, 0, 0),
               ("8-bit, (key, index) + gather", 8, True, 0, 0),
               ("11-bit, (key, index) + gather", 11, True, 0, 0)))


def build() -> list:
    """One library a config, all nvcc runs started together."""
    from particle_sim_tpu_torch.utils import cuda_build

    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for c, (name, flags) in enumerate(CONFIGS):
        out = BUILD / f"libradix_variants{c}.so"
        defs = [f"-D{k}={v}" for k, v in flags.items()]
        jobs.append((name, out, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *defs, "-shared",
             "-o", str(out), str(HERE / "radix_variants.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for name, out, proc in jobs:
        text, _ = proc.communicate()
        lines = text.splitlines()
        for k, ln in enumerate(lines):   # registers of the 8-bit kernels
            if "Compiling entry" in ln and "ILi8E" in ln:
                kern = ln.split("'")[1].split("_cu_")[-1][8:]
                regs = next((x for x in lines[k + 1:k + 6]
                             if "registers" in x), "").split(":")[-1]
                print(f"  {name}: {kern}:{regs}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({name}):\n{text}")
        libs.append(out)
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("radix_variants: needs an NVIDIA GPU (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 1
    import numpy as np

    from particle_sim_tpu_torch.core import generate as gen
    from particle_sim_tpu_torch.core.params import PMConfig, SimParams
    from particle_sim_tpu_torch.core.state import ParticleState
    from particle_sim_tpu_torch.ops import pm, psort
    from particle_sim_tpu_torch.render import raster
    from particle_sim_tpu_torch.render.camera import Camera

    sys.path.insert(0, str(ROOT))
    from chip_smoke import bytes_ms, median_ms

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    libs = []
    for path in build():
        lib = ctypes.CDLL(str(path))
        lib.probe_hist.argtypes = (I, P, I, I, P, I64, P)
        lib.probe_pass.argtypes = (I, I, *([P] * 12), I, I, I, I, P, I64, P)
        lib.probe_gather.argtypes = (P, P, P, P, P, P, P, I, I, P)
        libs.append(lib)
    tiles_of = [256 * int(flags.get("RS_ITEMS", psort.RADIX_TILE // 256))
                for _, flags in CONFIGS]
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

    def check(err, what):
        if err:
            raise RuntimeError(f"{what}: CUDA error {err}")

    def pad(ts, k):
        return [t.data_ptr() for t in ts] + [None] * (k - len(ts))

    def workspace_bytes(n, bits, tile):
        digits, values = psort.radix_digits(bits), 1 << bits
        return (8 * digits * -(-n // tile) * values + 4 * digits * values
                + 4 * digits)

    def probe_hist(config, key):
        n = key.shape[0]
        ws = torch.empty(workspace_bytes(n, 8, tiles_of[config]),
                         dtype=torch.uint8, device=dev)
        flip = -(1 << 31) if key.dtype == torch.int32 else 0
        check(libs[config].probe_hist(8, key.data_ptr(), n, flip,
                                      ws.data_ptr(), ws.numel(), stream()),
              "hist")
        return ws

    def probe_sort(bits, kernel, config, ops, iota):
        lib = libs[config]
        key = ops[0]
        n = key.shape[0]
        flip = -(1 << 31) if key.dtype == torch.int32 else 0
        words = [key, iota] if iota is not None else list(ops)
        ws = torch.empty(workspace_bytes(n, bits, tiles_of[config]),
                         dtype=torch.uint8, device=dev)
        out = [torch.empty_like(w) for w in words]
        scr = [torch.empty_like(w) for w in words]
        check(lib.probe_hist(bits, key.data_ptr(), n, flip, ws.data_ptr(),
                             ws.numel(), stream()), "hist")
        for d in range(psort.radix_digits(bits)):
            check(lib.probe_pass(bits, kernel, *pad(words, 4), *pad(out, 4),
                                 *pad(scr, 4), n, d, len(words) - 1, flip,
                                 ws.data_ptr(), ws.numel(), stream()),
                  "pass")
        if iota is None:
            return out
        pays = list(ops[1:])
        got = [torch.empty_like(p) for p in pays]
        check(lib.probe_gather(out[1].data_ptr(), *pad(pays, 3),
                               *pad(got, 3), n, len(pays), stream()),
              "gather")
        return [out[0]] + got

    def library(ops):
        key = ops[0] if ops[0].dtype == torch.int32 else psort.ordered_key(
            ops[0])
        order = torch.sort(key).indices
        return [torch.index_select(o.view(torch.int32), 0, order)
                for o in ops[1:]]

    def hollow(n, seed):
        p, _, c = gen.generate(n)
        v = np.random.default_rng(seed).normal(size=p.shape) * 3.0
        return ParticleState.from_arrays(p, v.astype(np.float32), c,
                                         device=dev)

    def pm_words(st):
        cfg = PMConfig()
        g = cfg.grid
        posf = st.pos.reshape(3, -1)
        c = pm.cell_coords_dyn(posf, cfg.box_min, cfg.cell_size, g, False)
        fl = torch.floor(c)
        i0 = fl.to(torch.int32)
        fq = torch.round((c - fl) * 1023.0).to(torch.int32)
        idx = torch.arange(posf.shape[1], dtype=torch.int32, device=dev)
        key = torch.where(idx < st.n_active,
                          (i0[2] * g + i0[1]) * g + i0[0], g ** 3)
        return [key, idx, fq[0] | (fq[1] << 10) | (fq[2] << 20)]

    def tile_words(st, w, h):
        tk = raster.tile_keys(
            st.pos, st.vel, st.init_color,
            torch.from_numpy(SimParams(color_mode=1).pack()).to(dev),
            torch.from_numpy(Camera(aspect=w / h).view_proj()).to(dev),
            st.n_active, width=w, height=h)
        return [tk.key, tk.r, tk.g, tk.b]

    s1, s16 = hollow(1_000_000, 0), hollow(16_777_216, 0)
    rng = np.random.default_rng(7)
    rand16 = [torch.from_numpy(rng.integers(0, 1 << 32, 16_777_216,
                                            dtype=np.uint64)
                               .astype(np.uint32)).to(dev)]
    rand16 += list(torch.randn((3, 16_777_216), device=dev))
    inputs = [("PM words 1M (key, idx, frac)", pm_words(s1)),
              ("PM words 16M (key, idx, frac)", pm_words(s16)),
              ("tile keys + rgb 1M @ 1280x720", tile_words(s1, 1280, 720)),
              ("tile keys + rgb 16M @ 1920x1080",
               tile_words(s16, 1920, 1080)),
              ("random uint32 + 3 words 16M", rand16)]
    report = {"device": torch.cuda.get_device_name(0), "card": card,
              "inputs": {}}
    for label, ops in inputs:
        n, words = ops[0].shape[0], len(ops)
        iota = torch.arange(n, dtype=torch.int32, device=dev)
        plain = psort.radix_sort_ref(ops)
        passes = len(psort.radix_plan_ref(ops[0]))
        fns = [(lambda: psort.sort(ops)) if bits is None else
               (lambda bits=bits, via=via, kern=kern, c=c: probe_sort(
                   bits, kern, c, ops, iota if via else None))
               for _, bits, via, kern, c in VARIANTS]
        for (name, *_), fn in zip(VARIANTS, fns):
            got = fn()
            for w, (g_, p_) in enumerate(zip(got, plain)):
                if not torch.equal(g_.view(torch.int32), p_.view(torch.int32)):
                    raise AssertionError(f"{label} {name}: word {w} differs "
                                         f"from plain")
        extra = [lambda: psort.merge_sort(ops), lambda: library(ops),
                 lambda: psort.radix_histogram(ops[0]),
                 lambda: torch.arange(n, dtype=torch.int32, device=dev)]
        extra += [lambda c=c: probe_hist(c, ops[0])
                  for c in range(len(CONFIGS))]
        big = n > 2_000_000
        inner = 3 if big else 10
        ms = median_ms(fns + extra, reps=5, inner=inner,
                       lead_ms=inner * (4.0 if big else 0.4))
        bound = bytes_ms(4 * n + passes * 8 * words * n)
        print(f"{label}: n {n}, {words} words, {passes} passes of 8 bits "
              f"({len(psort.radix_plan_ref(ops[0], 11))} of 11); bytes bound "
              f"{bound:.5f} ms (the histogram's {bytes_ms(4 * n):.5f} ms)")
        names = [v[0] for v in VARIANTS] + [
            "merge sort (psort.merge_sort)", "torch.sort(key) + index_select",
            "histogram alone (psort.radix_histogram)",
            "torch.arange of the index (the (key, index) variants' input)"
        ] + [f"histogram alone, {name}" for name, _ in CONFIGS]
        hist_bound = bytes_ms(4 * n)
        for k, (name, t_) in enumerate(zip(names, ms)):
            # the sorts against the sort's bound, the histograms against
            # theirs (the keys read once), torch.arange against none
            b = bound if k < len(VARIANTS) + 2 else hist_bound
            share = "" if "arange" in name else f" ({b / t_:.1%} of the bound)"
            print(f"  {name}: {t_:.5f} ms{share}")
        report["inputs"][label] = {"n": n, "words": words, "passes": passes,
                                   "bound_ms": bound,
                                   "ms": dict(zip(names, ms))}
    (BUILD / "report.json").write_text(json.dumps(report, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
