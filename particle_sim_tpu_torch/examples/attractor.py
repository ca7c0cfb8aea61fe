"""The reference's core interaction, scripted: a million particles chasing
an orbiting attractor (the left-drag behavior of app.rs:244-280, headless).

    python -m particle_sim_tpu_torch.examples.attractor --device cuda \
        --count 1000000 --steps 600

Counterpart of ``examples/attractor.py``: the same arguments, plus
``--device {cuda,cpu}`` ('cuda' never falls back), and the same stats
line every 100 steps.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--count", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--force", type=float, default=50.0)
    ap.add_argument("--radius", type=float, default=25.0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device of the state; 'cuda' never falls back")
    return ap


def build(args, method=None):
    """-> (engine, base SimParams, camera None): the attractor engine at
    ``args.count`` on ``args.device`` (``method``: the engine's default
    when None). :func:`orbit` gives the parameters of step i."""
    from ..core.params import SimParams
    from ..engine import Engine

    engine = Engine(particle_count=args.count, method=method,
                    device=args.device)
    base = SimParams(is_mouse_dragging=True, mouse_force=args.force,
                     mouse_radius=args.radius, color_mode=1)
    return engine, base, None


def orbit(base, i: int):
    """``base`` with the attractor at step i of its orbit."""
    ang = i * 0.02
    return base.replace(mouse_position=(
        40 * np.cos(ang), 10 * np.sin(2.3 * ang), 40 * np.sin(ang)))


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    engine, base, _ = build(args)
    for i in range(args.steps):
        engine.step(orbit(base, i))
        if (i + 1) % 100 == 0:
            d = engine.diagnostics()
            print(json.dumps({"step": i + 1, "mean_radius": d.mean_radius,
                              "max_speed": d.max_speed,
                              **engine.stats.snapshot()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
