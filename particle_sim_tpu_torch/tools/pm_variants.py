"""Time the candidate designs of the particle-mesh deposit and gather
kernels in turns, on one card, on the shapes of chip_smoke.py's phase 13.

    python3 -m particle_sim_tpu_torch.tools.pm_variants   # repo root, one GPU

Builds ``pm_variants.cu`` (the earlier design as variant 0, the candidates
after it) with nvcc into ``build/pm_variants/``, and on three inputs (1M
and 16,777,216 hollow-sphere particles, G = 128, static box, unit masses;
the final state of the PM CLI's ``--pm --central-mass 1000`` run, 1M
particles after 200 steps, with its masses) checks every variant against
the plain versions (``pm_cuda.deposit_plain``: 1e-5 max|p|, on the CLI
state instead within K u |p| of a float64 sum, K the cell's
contributions, as chip_smoke.py holds it there;
``pm_cuda.gather_plain``: 1e-6 max|p|; the loads-only variants are not
checked) and prints CUDA-event medians of each variant beside the
package's own kernels (``pm_cuda.deposit``, ``pm_cuda.gather`` on the
interleaved grids), ``grid_sample``, a planar-to-interleaved copy and the
solve with either output. Also prints each variant's registers
(``ptxas -v``), a count of the memory and warp instructions in the SASS
of the variants and the package's PM kernels, and which spellings
of the vector reduction ``red.global.add.v2.f32`` the installed ptxas
takes. The numbers also go to ``build/pm_variants/report.json``. Exits
1 without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
BUILD = ROOT / "build" / "pm_variants"
#: (name, variant number in pm_variants.cu, or None: the package's kernel)
DEPOSITS = (("v0 earlier: 8 scalar atomics", 0),
            ("v1 warp-aggregated, scalar", 1),
            ("v2 float2 x pairs", 2),
            ("v3 warp-aggregated, float2 x pairs", 3),
            ("v4 float4 x pairs", 4),
            ("v5 warp-aggregated, float4 x pairs", 5),
            ("this design (pm_cuda.deposit): v5 + block merge in shared "
             "memory", None))
#: (name, variant, checked against plain); None: the package's kernel on
#: the interleaved view pm.solve_accel returns
GATHERS = (("v0 earlier: planar, 24 scalar loads", 0, True),
           ("v1 planar loads only", 1, False),
           ("this design (pm_cuda.gather): interleaved, 8 float4 loads",
            None, True),
           ("v3 interleaved, 2 particles a thread", 3, True),
           ("v4 interleaved loads only", 4, False),
           ("v5 setup and output only", 5, False))
# spellings of the float2 reduction for the ptxas probe
RED_SPELLINGS = ("red.global.add.v2.f32", "red.global.v2.f32.add",
                 "red.relaxed.gpu.global.add.v2.f32")
SASS_OPS = ("LDG.E.128", "LDG.E.64", "LDG.E", "REDG", "RED", "ATOMG",
            "ATOMS", "ATOM", "MATCH", "SHFL", "VOTE", "STG.E")


def _nvcc() -> str:
    from particle_sim_tpu_torch.utils import cuda_build
    return cuda_build._nvcc()


def build() -> Path:
    from particle_sim_tpu_torch.utils import cuda_build

    BUILD.mkdir(parents=True, exist_ok=True)
    out = BUILD / "libpm_variants.so"
    proc = subprocess.run(
        [_nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o", str(out),
         str(HERE / "pm_variants.cu")], capture_output=True, text=True)
    for ln in (proc.stdout + proc.stderr).splitlines():
        if "registers" in ln or "spill" in ln or "error" in ln:
            print(f"  ptxas: {ln.strip()}")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return out


def red_spellings() -> dict:
    """Which inline-PTX spellings of a float2 reduction ptxas accepts."""
    from particle_sim_tpu_torch.utils import cuda_build

    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        for k, op in enumerate(RED_SPELLINGS):
            src = Path(tmp) / f"red{k}.cu"
            src.write_text(
                "__global__ void k(float* p, float a, float b) {\n"
                f'  asm volatile("{op} [%0], {{%1, %2}};" :: "l"(p), '
                '"f"(a), "f"(b) : "memory");\n}\n')
            proc = subprocess.run(
                [_nvcc(), *cuda_build.ARCH_FLAGS, "-c", "-o",
                 str(Path(tmp) / f"red{k}.o"), str(src)],
                capture_output=True, text=True)
            got[op] = (proc.returncode == 0 or
                       (proc.stdout + proc.stderr).strip().splitlines()[-1:])
    return got


def sass_summary(lib: Path) -> dict:
    """{kernel: {opcode: count}} of the variants' SASS."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split()[0]
        ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                         body, re.M)
        counts = {}
        for op in ops:
            for want in SASS_OPS:
                if op == want or op.startswith(want + "."):
                    if want in ("LDG.E", "STG.E") and op != want and \
                            re.match(r"^(LDG|STG)\.E\.(64|128)", op):
                        continue
                    counts[want] = counts.get(want, 0) + 1
                    break
        out[name] = counts
    return out


def cli_b_state(dev):
    """(pos f32[3, cap], n_active, masses f32[cap]) of the PM CLI's
    --pm --central-mass 1000 run after 200 steps at 1M (chip_smoke.py's
    phase 12 run (b), without frames)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from particle_sim_tpu_torch.app import cli
    from particle_sim_tpu_torch.core.state import ParticleState

    with tempfile.TemporaryDirectory() as tmp:
        final = os.path.join(tmp, "final.npz")
        argv = ["--device", "cuda", "--count", "1000000", "--steps", "200",
                "--pm", "--central-mass", "1000", "--checkpoint-every",
                "200", "--checkpoint", final, "--stats-every", "100"]
        with contextlib.redirect_stdout(io.StringIO()):
            if cli.main(argv) != 0:
                raise RuntimeError("pm cli (b) failed")
        with np.load(final) as z:
            p, v, c, m = (z["positions"], z["velocities"], z["init_colors"],
                          z["masses"])
    st = ParticleState.from_arrays(p, v, c, device=dev)
    pos = st.pos.reshape(3, -1)
    masses = torch.ones(pos.shape[1], dtype=torch.float32, device=dev)
    masses[:m.shape[0]] = torch.from_numpy(m).to(dev)
    return pos, st.n_active, masses


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pm_variants: needs an NVIDIA GPU (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 1
    import numpy as np

    from particle_sim_tpu_torch.core import generate as gen
    from particle_sim_tpu_torch.core.params import PMConfig
    from particle_sim_tpu_torch.core.state import ParticleState
    from particle_sim_tpu_torch.ops import pm, pm_cuda
    from particle_sim_tpu_torch.utils import cuda_build

    # chip_smoke.py's timing, corner and bound helpers (run from the root)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bytes_ms, cic_corners, median_ms

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    lib_path = build()
    lib = ctypes.CDLL(str(lib_path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.probe_deposit.argtypes = (I, P, I, P, P, P, P, P, I, F, I, P, P)
    lib.probe_gather.argtypes = (I, P, P, I, P, P, P, P, I, F, I, P, P)
    print(f"red.v2 spellings ptxas takes: {red_spellings()}")
    for name, counts in sass_summary(lib_path).items():
        print(f"  sass {name}: {counts}")
    for name, counts in sass_summary(cuda_build.build()[0]).items():
        if "pm_" in name:
            print(f"  sass (package) {name}: {counts}")

    cfg = PMConfig()
    g = cfg.grid
    hi = pm.clamp_limit(g, False)
    box_t, cell_t = pm_cuda.static_box(tuple(cfg.box_min),
                                       float(cfg.cell_size), dev)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

    def dep(v, pos, na_t, masses):
        rho = torch.zeros((g, g, g), dtype=torch.float32, device=dev)
        err = lib.probe_deposit(
            v, pos.data_ptr(), pos.shape[1], na_t.data_ptr(), None,
            None if masses is None else masses.data_ptr(), box_t.data_ptr(),
            cell_t.data_ptr(), g, hi, 0, rho.data_ptr(), stream())
        if err:
            raise RuntimeError(f"deposit v{v}: CUDA error {err}")
        return rho

    def gat(v, grids, pos, na_t):
        out = torch.empty((3, pos.shape[1]), dtype=torch.float32, device=dev)
        err = lib.probe_gather(
            v, grids.data_ptr(), pos.data_ptr(), pos.shape[1],
            na_t.data_ptr(), None, box_t.data_ptr(), cell_t.data_ptr(), g, hi,
            0, out.data_ptr(), stream())
        if err:
            raise RuntimeError(f"gather v{v}: CUDA error {err}")
        return out

    def earlier_solve(rho):
        """The solve as the earlier design ended it: dense planes (one
        contiguous copy out of the padded inverse transform)."""
        (k0, k1, k2) = pm.base_kernels_device(cfg, cfg.softening,
                                              device=dev)
        rho_hat = torch.fft.rfftn(torch.nn.functional.pad(
            rho, (0, g, 0, g, 0, g)))
        x = torch.fft.ifft(rho_hat[None] * torch.stack((k0, k1, k2)), dim=1)
        x = torch.fft.ifft(x[:, :g], dim=2)[:, :, :g]
        return torch.fft.irfft(x, n=2 * g, dim=3)[..., :g].contiguous()

    def hollow(n):
        p, v, c = gen.generate(n)
        return ParticleState.from_arrays(p, v, c, device=dev)

    inputs = []
    for n in (1_000_000, 16_777_216):
        st = hollow(n)
        inputs.append((f"n={n}", st.pos.reshape(3, -1), st.n_active, None))
    inputs.append(("cli (b) final state n=1000000, masses", *cli_b_state(dev)))

    report = {"device": torch.cuda.get_device_name(0), "card": card,
              "shapes": {}}
    for label, pos, na, masses in inputs:
        n = pos.shape[1]
        na_t = torch.tensor([int(na)], dtype=torch.int32, device=dev)
        big = n > 2_000_000
        inner = 3 if big else 10
        lead = inner * (4.0 if big else 0.5)
        # -- deposit: check, then time --------------------------------------
        dp = pm_cuda.deposit_plain(pos, na, box_t, cell_t, g, periodic=False,
                                   masses=masses)
        exact = counts = None
        if masses is not None:
            # a float64 sum of the same f32 corner weights, and each cell's
            # nonzero contributions K: an f32 sum of K non-negative terms in
            # any order lies within (K - 1) u of it
            idx, w = cic_corners(pos, na, box_t, cell_t, g, False, masses)
            idx, w = idx.reshape(-1), w.reshape(-1).double()
            exact = torch.zeros(g ** 3, dtype=torch.float64,
                                device=dev).index_add_(0, idx, w)
            counts = torch.bincount(idx, weights=(w != 0).double(),
                                    minlength=g ** 3)
        torch.cuda.synchronize()
        scale = float(dp.abs().max())
        fns = [(lambda v=v: dep(v, pos, na_t, masses)) if v is not None
               else (lambda: pm_cuda.deposit(pos, na, box_t, cell_t, g,
                                             periodic=False, masses=masses))
               for _, v in DEPOSITS]
        dep_notes = []
        for (name, _), fn in zip(DEPOSITS, fns):
            dk = fn()
            e = float((dk - dp).abs().max())
            note = f"max |k - p| {e:.3g}"
            if exact is None and not e <= 1e-5 * scale:
                raise AssertionError(f"{label} deposit {name}: max |k - p| "
                                     f"{e} > 1e-5 max|p| {scale}")
            if exact is not None:
                ratio = float(((dk.reshape(-1).double() - exact).abs()
                               / (counts * 2.0 ** -24 * exact)
                               .clamp_min(1e-300)).max())
                if not ratio <= 1.0:
                    raise AssertionError(f"{label} deposit {name}: |k - p| "
                                         f"/ (K u |p|) {ratio}")
                note += f", worst |k - p| / (K u |p|) {ratio:.4g}"
            dep_notes.append(note)
        dep_ms = median_ms(fns, reps=5, inner=inner, lead_ms=lead)
        d_bound = bytes_ms(n * (12 + (0 if masses is None else 4))
                           + 4 * g ** 3)
        # -- gather ------------------------------------------------------------
        grids = pm.solve_accel(dp, cfg, cfg.softening)   # interleaved view
        planar = grids.contiguous()
        same_solve = torch.equal(earlier_solve(dp), planar)
        gp = pm_cuda.gather_plain(planar, pos, na, box_t, cell_t,
                                  periodic=False)
        torch.cuda.synchronize()
        gscale = float(gp.abs().max())
        fns = [(lambda v=v: gat(v, planar if v < 2 else grids, pos, na_t))
               if v is not None
               else (lambda: pm_cuda.gather(grids, pos, na, box_t, cell_t,
                                            periodic=False))
               for _, v, _ in GATHERS]
        gat_notes = []
        for (name, _, checked), fn in zip(GATHERS, fns):
            if not checked:
                gat_notes.append("")
                continue
            e = float((fn() - gp).abs().max())
            if not e <= 1e-6 * gscale:
                raise AssertionError(f"{label} gather {name}: max |k - p| {e}"
                                     f" > 1e-6 max|p| {gscale}")
            gat_notes.append(f", max |k - p| {e:.3g}")
        cc = pm.cell_coords_dyn(pos, box_t, cell_t, g, False)
        norm = (cc / (g - 1) * 2.0 - 1.0).T.reshape(1, 1, 1, n, 3).contiguous()
        lib_grids = planar[None]
        il = torch.empty((g, g, g, 4), dtype=torch.float32, device=dev)
        fns += [lambda: torch.nn.functional.grid_sample(
                    lib_grids, norm, mode="bilinear", padding_mode="border",
                    align_corners=True),
                lambda: il[..., :3].copy_(planar.permute(1, 2, 3, 0)),
                lambda: pm.solve_accel(dp, cfg, cfg.softening),
                lambda: earlier_solve(dp)]
        gat_ms = median_ms(fns, reps=5, inner=inner, lead_ms=lead)
        g_bound = bytes_ms(n * 24 + 12 * g ** 3)
        hot = "" if counts is None else \
            f"; hottest cell {int(counts.max())} contributions"
        print(f"{label} deposit (bound {d_bound:.5f} ms; max|p| {scale:.6g}"
              f"{hot}):")
        for (name, _), ms, note in zip(DEPOSITS, dep_ms, dep_notes):
            print(f"  {name}: {ms:.5f} ms, {note}")
        print(f"{label} gather (bound {g_bound:.5f} ms; max|p| {gscale:.6g}):")
        for (name, _, _), ms, note in zip(GATHERS, gat_ms, gat_notes):
            print(f"  {name}: {ms:.5f} ms{note}")
        k = len(GATHERS)
        print(f"  grid_sample {gat_ms[k]:.5f} ms | planar -> interleaved "
              f"copy {gat_ms[k + 1]:.5f} ms | solve to the interleaved view "
              f"{gat_ms[k + 2]:.5f} ms, to dense planes (earlier) "
              f"{gat_ms[k + 3]:.5f} ms (equal values: {same_solve})")
        report["shapes"][label] = {
            "deposit_ms": {name: ms for (name, _), ms in zip(DEPOSITS,
                                                             dep_ms)},
            "deposit_bound_ms": d_bound,
            "gather_ms": {name: ms for (name, _, _), ms in zip(GATHERS,
                                                               gat_ms)},
            "grid_sample_ms": gat_ms[k], "relayout_ms": gat_ms[k + 1],
            "solve_ms": gat_ms[k + 2], "earlier_solve_ms": gat_ms[k + 3],
            "gather_bound_ms": g_bound}
    (BUILD / "report.json").write_text(json.dumps(report, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
