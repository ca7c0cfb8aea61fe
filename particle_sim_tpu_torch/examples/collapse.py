"""Self-gravitating collapse of a million-particle cloud (particle-mesh).

Runs the PM solver with the auto-zoom box, tracks energy/virial diagnostics,
and writes a frame sequence. On an NVIDIA H100 80GB HBM3 (power limit
700 W) a step at 1M particles takes ~1.96 ms host-paced (~510 steps a
second), and the 600 steps with ten diagnostics lines and frames ~6.2 s
of wall (chip_smoke.py phase 22).

    python -m particle_sim_tpu_torch.examples.collapse --device cuda \
        --count 1000000 --steps 600 --out frames/

Counterpart of ``examples/collapse.py``: the same arguments, plus
``--device {cuda,cpu}`` ('cuda' never falls back), and the same
diagnostics lines (the potential at this count is the mesh estimate: one
more deposit and a one-channel gather).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--count", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--g", type=float, default=0.08)
    ap.add_argument("--softening", type=float, default=4.0)
    ap.add_argument("--dt", type=float, default=0.004)
    ap.add_argument("--out", default="")
    ap.add_argument("--render-every", type=int, default=60)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device of the state; 'cuda' never falls back")
    return ap


def build(args, method=None):
    """-> (engine, SimParams, Camera): a filled sphere under the PM solver
    with the auto box, undamped."""
    from ..core.params import (
        PairwiseParams, PMConfig, SimParams, SphereGeneration,
    )
    from ..engine import Engine
    from ..render.camera import Camera

    engine = Engine(
        particle_count=args.count, method=method, device=args.device,
        generation_mode=SphereGeneration.FILLED,
        pairwise=PairwiseParams(args.g, args.softening),
        pm=PMConfig(softening=args.softening, auto_box=True),
    )
    params = SimParams(delta_time=args.dt, color_mode=1,
                       damping=1.0)  # undamped: watch the energy
    return engine, params, Camera(aspect=16 / 9)


def main(argv: Optional[list] = None) -> int:
    from ..utils.png import write_png

    args = build_parser().parse_args(argv)
    engine, params, camera = build(args)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for i in range(args.steps):
        engine.step(params)
        if (i + 1) % args.render_every == 0:
            d = engine.diagnostics(potential=True)
            print(json.dumps({"step": i + 1, **d.as_dict()}))
            if args.out:
                img = engine.render_frame(camera, params,
                                          width=1280, height=720)
                write_png(os.path.join(args.out, f"c_{i + 1:05d}.png"), img)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
