"""Deep zoom: MULTI-level PM on the PERSISTENT order — the flagship
solver composition.

A halo hosting a compact cluster hosting a dense core: three dynamical
scales, no single softening can resolve them all. The nested refinement
stack (pm2 tuple, windows auto-tracking each parent level's centroid)
gives every pair the softening of the innermost window containing it,
and ``pm_persist=True`` keeps the particles in the stack's class order
between frames (ops/pm_persist.py): a frame sorts nothing, and a repair
(one radix sort of the mirror) fires when the disorder, adjacent slots
whose class key decreases, passes a quarter of the live count.

    python -m particle_sim_tpu_torch.examples.deep_zoom --device cuda \
        --count 500000 --steps 300 --out frames/
    python -m particle_sim_tpu_torch.examples.deep_zoom --device cpu \
        --count 3000 --steps 6

The same configuration via the CLI / server:

    python -m particle_sim_tpu_torch.app.cli --device cuda --count 16777216 \
        --pm --pm-persist --pm2-size 32 8 --pm2-softening 0.6 0.2 --steps 600
    python -m particle_sim_tpu_torch.app.server --device cuda \
        --count 16777216 --pm-persist --pm2-size 32 8 \
        --pm2-softening 0.6 0.2 --view-mode raster

The ``--exact`` run (this script's physics and its exact window) via the
CLI, with a capacity that holds every member:

    python -m particle_sim_tpu_torch.app.cli --device cuda --count 500000 \
        --pm --pm-persist --pm-softening 3.0 --pairwise-g 0.05 \
        --pm2-size 32 8 --pm2-softening 0.6 0.2 --pmx-size 2 \
        --pmx-softening 0.05 --pmx-capacity 147456 --steps 600

At 500,000 the 2-unit window holds ~129k members at the start and 38k-87k
past step 100 (H100), so this script's capacity of 8,192 corrects only
the first of them in the mirror's slot order (the engine warns once).

Counterpart of ``examples/deep_zoom.py``: the same arguments, plus
``--device {cuda,cpu}`` ('cuda' never falls back), and the same lines.
The printed ``repairs`` differ from the JAX script's by design: the
port repairs on disorder, not on overflowing table budgets, and makes
its mirror in the class order at once, so it counts one repair fewer on
this multi-level run.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np


def make_scene(n: int, seed: int = 13):
    """Halo (r=40) + cluster (r=4 at offset) + core (r=0.8 inside it)."""
    rng = np.random.default_rng(seed)
    n_core, n_cl = n // 4, n // 4
    center = np.float32([14.0, 6.0, -4.0])

    def ball(k, radius, off):
        d = rng.normal(size=(k, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        r = radius * rng.random(k).astype(np.float32) ** (1 / 3)
        return d * r[:, None] + off

    pos = np.concatenate([ball(n_core, 0.8, center),
                          ball(n_cl, 4.0, center),
                          ball(n - n_core - n_cl, 40.0, 0.0)])
    vel = np.zeros_like(pos)
    # solid-body spin for the cluster+core so the stack has something
    # to track (the centroid orbits slightly as the halo responds)
    rel = pos[: n_core + n_cl] - center
    vel[: n_core + n_cl, 0] = -0.25 * rel[:, 2]
    vel[: n_core + n_cl, 2] = 0.25 * rel[:, 0]
    return pos, vel


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--count", type=int, default=500_000)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--g", type=float, default=0.05)
    ap.add_argument("--out", default="")
    ap.add_argument("--stats-every", type=int, default=50)
    ap.add_argument("--exact", action="store_true",
                    help="terminate the stack with the window-EXACT "
                         "pmx correction (ops/pmx.py): pairs of members "
                         "of the 2-unit core window feel the exact 0.05 "
                         "softening through the all-pairs kernel; past the "
                         "capacity of 8,192 the first members by slot order "
                         "are corrected (the engine warns once)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device of the state; 'cuda' never falls back")
    return ap


def build(args, method=None):
    """-> (engine, SimParams, Camera): the persistent two-level stack
    (with ``--exact`` the pmx window too), given the scene at the engine's
    capacity."""
    from ..core.params import PairwiseParams, PMConfig, SimParams
    from ..core.state import ParticleState
    from ..engine import Engine
    from ..ops.pm2 import PM2Config
    from ..ops.pmx import PMXConfig
    from ..render.camera import Camera

    pos, vel = make_scene(args.count)
    engine = Engine(
        particle_count=args.count, method=method, device=args.device,
        pm=PMConfig(softening=3.0),
        pairwise=PairwiseParams(args.g, 3.0),
        # nested stack: 32-unit window at 0.6 softening, 8-unit window
        # at 0.2 — each auto-tracking its parent level's centroid
        pm2=(PM2Config(window_min=None, window_size=32.0, softening=0.6),
             PM2Config(window_min=None, window_size=8.0, softening=0.2)),
        pm_persist=True,
        pmx=(PMXConfig(window_size=2.0, softening=0.05, capacity=8192)
             if args.exact else None),
    )
    engine.state = ParticleState.from_arrays(
        pos, vel, np.full_like(pos, 0.7), device=engine.device,
        capacity=engine.capacity)
    return engine, SimParams(delta_time=0.016, gravity=0.0), Camera()


def main(argv: Optional[list] = None) -> int:
    from ..utils.png import write_png

    args = build_parser().parse_args(argv)
    engine, params, cam = build(args)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    n_core = args.count // 4
    for i in range(args.steps):
        engine.step(params)
        if (i + 1) % args.stats_every == 0:
            p = engine.state.positions()
            core = p[:n_core]
            c = core.mean(axis=0)
            r_half = float(np.median(np.linalg.norm(core - c, axis=1)))
            print(f"step {i + 1}: core centroid {np.round(c, 2)}, "
                  f"half-mass radius {r_half:.3f}, repairs "
                  f"{engine.resorts}", flush=True)
            if args.out:
                img = engine.render_frame(cam, params, width=1280,
                                          height=720)
                write_png(os.path.join(args.out,
                                       f"frame_{i + 1:06d}.png"), img)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
