"""Stage breakdown of a particle-mesh frame on the card.

Counterpart of the JAX package's ``tools/pm_profile.py``:

    python -m particle_sim_tpu_torch.tools.pm_profile [N] [boundary]
    python -m particle_sim_tpu_torch.tools.pm_profile pmn [N]
        N         particle count (default 16777216)
        boundary  isolated | periodic (default isolated)
        --grid G  (default 128)   --device cuda | cpu (default cuda)

The default mode times the per-frame PM stages: the cell keys (the only
stage the persistent order adds), the deposit, the FFT solve, the
gather and the whole ``pm_cuda.pm_accel``; then the persistent frame on
a cell-sorted state (ops/pm_persist.py): the disorder verdict, one
repair, the deposit and gather on the sorted planes and the whole
``accel_sorted`` without a repair.

``pmn`` mode times the multi-level persistent frame at each level count
on the same uniform cloud (coarse only, one window as the two-level
``cfg2``, the multi-level order with one and with two windows), each
settled into its class order first, so that each level's cost is a
difference of numbers from one process; then the stages a level adds:
the nested window origins, the class keys and one difference solve.

Every time is the best of a few calls (utils/profiling.device_time: CUDA
events on the card). :func:`main` returns the times in ms by stage.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..core import params as P
from ..ops import pm, pm2, pm_cuda, pm_persist as pper
from ..utils import profiling

L1 = pm2.PM2Config(window_min=None, window_size=32.0, softening=0.5)
L2 = pm2.PM2Config(window_min=None, window_size=8.0, softening=0.2)


def _ms(fn, reps: int = 3) -> float:
    return profiling.device_time(fn, reps=reps)[0] * 1e3


def _cloud(n: int, device: torch.device, seed: int) -> tuple:
    """(pos f32[3, capacity], n_active int32 0-d): n particles uniform in
    [-45, 45)^3, then zeros up to a capacity that is a multiple of 512
    (the persistent state's)."""
    g = torch.Generator(device=device).manual_seed(seed)
    cap = -(-n // 512) * 512
    pos = torch.zeros((3, cap), device=device)
    pos[:, :n] = torch.rand((3, n), generator=g, device=device) * 90.0 - 45.0
    return pos, torch.tensor(n, dtype=torch.int32, device=device)


def _report(times: dict, label: str, ms: float) -> None:
    times[label] = ms
    print(f"{label:32s} {ms:9.4f} ms", flush=True)


def profile_pm(n: int, cfg: "P.PMConfig", device: torch.device) -> dict:
    times: dict = {}
    pos, n = _cloud(n, device, 0)
    live = pm.live_mask(pos.shape[1], n, device)
    periodic = cfg.boundary == "periodic"
    box_min, cell = pm_cuda.static_box(tuple(cfg.box_min),
                                       float(cfg.cell_size), device)
    _report(times, "cell keys", _ms(lambda: pper.cell_keys(pos, live, cfg)))
    rho = pm_cuda.deposit(pos, n, box_min, cell, cfg.grid, periodic=periodic)
    _report(times, "deposit", _ms(lambda: pm_cuda.deposit(
        pos, n, box_min, cell, cfg.grid, periodic=periodic)))
    grids = pm.solve_accel(rho, cfg, cfg.softening)
    _report(times, "solve", _ms(lambda: pm.solve_accel(rho, cfg,
                                                       cfg.softening)))
    _report(times, "gather", _ms(lambda: pm_cuda.gather(
        grids, pos, n, box_min, cell, periodic=periodic)))
    _report(times, "whole pm_accel", _ms(lambda: pm_cuda.pm_accel(
        pos, n, 1.0, cfg)))

    st = pper.init_sorted(pos, n, cfg)
    sp, live = st.pos, st.ids < n
    _report(times, "persist: disorder verdict",
            _ms(lambda: pper.needs_repair(st, n, cfg)))
    _report(times, "persist: repair", _ms(lambda: pper.repair_state(
        st, n, cfg)))
    _report(times, "persist: deposit (sorted)", _ms(lambda: pm_cuda.deposit(
        sp, n, box_min, cell, cfg.grid, periodic=periodic, live=live)))
    _report(times, "persist: gather (sorted)", _ms(lambda: pm_cuda.gather(
        grids, sp, n, box_min, cell, periodic=periodic, live=live)))
    _report(times, "persist: whole accel_sorted", _ms(
        lambda: pper.accel_sorted(st, 1.0, cfg, n_active=n,
                                  repair=False)[1]))
    return times


def profile_pmn(n: int, cfg: "P.PMConfig", device: torch.device) -> dict:
    times: dict = {}
    pos, n = _cloud(n, device, 2)
    st0 = pper.init_sorted(pos, n, cfg)
    t0 = _ms(lambda: pper.accel_sorted(st0, 1.0, cfg, n_active=n,
                                       repair=False)[1])
    _report(times, "frame coarse only", t0)
    st_2l = pper.init_sorted(pos, n, cfg, cfg2=L1)
    _report(times, "frame two-level cfg2 (L1)", _ms(
        lambda: pper.accel_sorted(st_2l, 1.0, cfg, n_active=n, cfg2=L1,
                                  repair=False)[1]))
    rows = {}
    for k, levels in ((1, (L1,)), (2, (L1, L2))):
        stm = pper.init_sorted_multi(pos, n, cfg, levels)
        rows[k] = (stm, levels)
        _report(times, f"frame multi k={k}", _ms(
            lambda stm=stm, levels=levels: pper.accel_sorted_multi(
                stm, 1.0, cfg, levels, n_active=n, repair=False)[1]))
    stm, levels = rows[2]
    live = stm.ids < n
    _report(times, "  nested window origins", _ms(
        lambda: pm2._nested_wmins(stm.pos, live, cfg, levels, None)))
    _report(times, "  class keys (k=2)", _ms(
        lambda: pper.state_keys(stm, n, cfg, levels)))
    rho = pm_cuda.deposit(pos, n, *pm_cuda.static_box(
        tuple(cfg.box_min), float(cfg.cell_size), device), cfg.grid,
        periodic=False)
    h2 = L2.window_size / cfg.grid
    _report(times, "  difference solve (1 level)", _ms(
        lambda: pm.solve_accel_diff(rho, cfg.grid, h2, L2.softening,
                                    L1.softening, L2.gradient)))
    return times


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="particle_sim_tpu_torch.tools."
                                 "pm_profile", description=__doc__.split(
                                     "\n")[0])
    ap.add_argument("args", nargs="*",
                    help="[N] [boundary], or pmn [N]")
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("pm_profile times the card, and "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu for a CPU run")
    pmn = bool(a.args) and a.args[0] == "pmn"
    rest = a.args[1:] if pmn else a.args
    n = int(rest[0]) if rest else 16 * 1024 * 1024
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if pmn:
        cfg = P.PMConfig(grid=a.grid, softening=2.0)
        print(f"pmn mode on {name}: N={n} cfg {cfg}, levels 32/0.5, 8/0.2",
              flush=True)
        return profile_pmn(n, cfg, device)
    cfg = P.PMConfig(grid=a.grid,
                     boundary=rest[1] if len(rest) > 1 else "isolated")
    print(f"PM stages on {name}: N={n} cfg {cfg}", flush=True)
    return profile_pm(n, cfg, device)


if __name__ == "__main__":
    main(sys.argv[1:])
