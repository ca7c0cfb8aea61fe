"""Headless command line: scripted attractor input, optional direct-sum
self-gravity, periodic frame renders to PNG, periodic checkpoints, stats
to stdout.

Counterpart of ``particle_sim_tpu/app/cli.py``, with the same flags and
the same stats and ``done`` JSON lines, plus ``--device {cuda,cpu}``. The
flags of parts not ported yet (the particle-mesh solvers, diagnostics,
the multi-device mesh) are accepted by the parser and raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.

Examples:
    python -m particle_sim_tpu_torch.app.cli --device cuda \
        --count 1000000 --steps 600 --drag --orbit-mouse --color-mode 1 \
        --render-every 100 --render-dir frames/
    python -m particle_sim_tpu_torch.app.cli --device cuda --pairwise \
        --central-mass 1000 --count 65536 --steps 200 --renderer sorted \
        --render-every 100
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="particle_sim_tpu_torch", description=__doc__.split("\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the state; 'cuda' never falls back")
    p.add_argument("--count", type=int, default=None,
                   help="particle count (default: 100k torch / 1M cuda)")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--method", choices=["auto", "torch", "cuda"],
                   default="auto",
                   help="stepper: plain PyTorch, or the CUDA kernel")
    p.add_argument("--generation", choices=["hollow", "filled"],
                   default="hollow")
    p.add_argument("--substeps", type=int, default=1)
    p.add_argument("--mesh", choices=["none", "auto"], default="none",
                   help="auto: shard particles over all visible devices "
                        "(not ported yet)")
    # SimParams surface
    p.add_argument("--dt", type=float, default=0.016)
    p.add_argument("--gravity", type=float, default=0.0)
    p.add_argument("--mouse-force", type=float, default=5.0)
    p.add_argument("--mouse-radius", type=float, default=10.0)
    p.add_argument("--mouse-pos", type=float, nargs=3,
                   default=[0.0, 0.0, 48.0])
    p.add_argument("--drag", action="store_true",
                   help="hold the attractor on (left-drag analog)")
    p.add_argument("--orbit-mouse", action="store_true",
                   help="script the attractor on a circular orbit")
    p.add_argument("--color-mode", type=int, choices=[0, 1, 2], default=0)
    p.add_argument("--max-dist-for-color", type=float, default=50.0)
    p.add_argument("--damping", type=float, default=0.99)
    # direct-sum self-gravity
    p.add_argument("--pairwise", action="store_true",
                   help="all-pairs O(N^2) softened gravity")
    p.add_argument("--pairwise-g", type=float, default=1.0)
    p.add_argument("--pairwise-softening", type=float, default=0.5)
    p.add_argument("--central-mass", type=float, default=0.0,
                   help="give particle 0 this source mass (heavy central "
                        "body for --pairwise runs)")
    # particle-mesh solvers (not ported yet: each raises NotImplementedError)
    p.add_argument("--pm", action="store_true")
    p.add_argument("--pm-grid", type=int, default=128)
    p.add_argument("--pm-softening", type=float, default=2.0)
    p.add_argument("--pm-box", type=float, nargs=4,
                   default=[-64.0, -64.0, -64.0, 128.0],
                   metavar=("XMIN", "YMIN", "ZMIN", "SIZE"))
    p.add_argument("--pm-boundary", choices=["isolated", "periodic"],
                   default="isolated")
    p.add_argument("--pm-auto-box", action="store_true")
    p.add_argument("--pm-gradient", choices=["exact", "fd"], default="exact")
    p.add_argument("--pm2-size", type=float, nargs="+", default=[0.0])
    p.add_argument("--pm2-window", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--pm2-softening", type=float, nargs="+", default=[0.5])
    p.add_argument("--pm2-margin", type=float, default=0.0)
    p.add_argument("--pmx-size", type=float, default=0.0)
    p.add_argument("--pmx-softening", type=float, default=0.1)
    p.add_argument("--pmx-capacity", type=int, default=65536)
    p.add_argument("--pm-persist", action="store_true")
    p.add_argument("--no-two-tier", action="store_true",
                   help="persistent-PM repair strategy (only with --pm)")
    # rendering
    p.add_argument("--render-every", type=int, default=0)
    p.add_argument("--render-dir", default="frames")
    p.add_argument("--renderer",
                   choices=["auto", "scatter", "sorted", "compact"],
                   default="auto",
                   help="compact: compaction + deposit kernels; sorted: "
                        "sorted-deposit kernel (both tile-aligned sizes); "
                        "scatter: plain PyTorch scatter")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    # checkpointing
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--checkpoint", default="checkpoint.npz")
    p.add_argument("--resume", default=None)
    p.add_argument("--stats-every", type=int, default=100)
    p.add_argument("--diagnostics", action="store_true",
                   help="physics observables in the stats lines")
    return p


def _refuse_not_ported(args) -> None:
    from ..engine.engine import not_ported

    for feature, given in (
            ("mesh", args.mesh != "none"),
            ("pm_persist", args.pm_persist),
            ("pm2", args.pm2_size[0] > 0.0),
            ("pmx", args.pmx_size > 0.0),
            ("pm", args.pm),
            ("diagnostics", args.diagnostics)):
        if given:
            raise not_ported(feature)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_not_ported(args)

    import torch

    from ..core.params import (
        Method, PairwiseParams, SimParams, SphereGeneration,
    )
    from ..engine import Engine
    from ..io import checkpoint as ckpt
    from ..render.camera import Camera
    from ..utils.png import write_png

    method = {"auto": None, "torch": Method.TORCH,
              "cuda": Method.CUDA}[args.method]
    start_step = 0
    if args.resume:
        engine, start_step = ckpt.load(args.resume, method=method,
                                       device=args.device)
        print(f"resumed from {args.resume} at step {start_step} "
              f"({engine.particle_count} particles)", file=sys.stderr)
        ignored = [name for name, given in (
            ("--count", args.count),
            ("--pairwise", args.pairwise),
            ("--substeps", args.substeps != 1),
            ("--generation", args.generation != "hollow"),
        ) if given]
        if ignored:
            print(f"note: {', '.join(ignored)} ignored on --resume "
                  "(the checkpoint's configuration wins)", file=sys.stderr)
    else:
        engine = Engine(
            particle_count=args.count,
            method=method,
            generation_mode=(SphereGeneration.HOLLOW
                             if args.generation == "hollow"
                             else SphereGeneration.FILLED),
            device=args.device,
            substeps=args.substeps,
            pairwise=(PairwiseParams(args.pairwise_g, args.pairwise_softening)
                      if args.pairwise else None),
        )

    if args.central_mass > 0.0:
        # applies to fresh AND resumed runs (overrides checkpoint masses)
        m = np.ones(engine.particle_count, np.float32)
        m[0] = args.central_mass
        engine.set_masses(m)

    camera = Camera(aspect=args.width / args.height)
    if args.render_every:
        os.makedirs(args.render_dir, exist_ok=True)

    base = SimParams(
        delta_time=args.dt, gravity=args.gravity,
        color_mode=args.color_mode, mouse_force=args.mouse_force,
        mouse_radius=args.mouse_radius,
        is_mouse_dragging=args.drag or args.orbit_mouse,
        damping=args.damping, max_dist_for_color=args.max_dist_for_color,
        mouse_position=tuple(args.mouse_pos),
    )

    t_start = time.perf_counter()
    for i in range(start_step, start_step + args.steps):
        params = base
        if args.orbit_mouse:
            ang = i * 0.02
            params = base.replace(mouse_position=(
                40.0 * np.cos(ang), 10.0 * np.sin(ang * 2.3),
                40.0 * np.sin(ang)))
        engine.step(params)

        if args.render_every and (i + 1) % args.render_every == 0:
            img = engine.render_frame(camera, params,
                                      width=args.width, height=args.height,
                                      renderer=args.renderer)
            path = os.path.join(args.render_dir, f"frame_{i + 1:06d}.png")
            write_png(path, img)
            print(f"wrote {path}", file=sys.stderr)

        if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            ckpt.save(args.checkpoint, engine, step_index=i + 1)
            print(f"checkpointed -> {args.checkpoint}", file=sys.stderr)

        if args.stats_every and (i + 1) % args.stats_every == 0:
            print(json.dumps({"step": i + 1, **engine.stats.snapshot()}))

    # final sync so the last step's cost is visible
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.perf_counter() - t_start
    total = args.steps * engine.substeps * engine.particle_count
    print(json.dumps({
        "done": True, "steps": args.steps, "wall_s": round(wall, 3),
        "particle_steps_per_sec": round(total / wall, 1),
        **engine.stats.snapshot(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
