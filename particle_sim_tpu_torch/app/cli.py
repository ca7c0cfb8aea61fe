"""Headless command line: scripted attractor input, optional self-gravity
(direct sum or particle mesh), periodic frame renders to PNG, periodic
checkpoints, stats (and physics diagnostics) to stdout.

Counterpart of ``particle_sim_tpu/app/cli.py``, with the same flags and
the same stats and ``done`` JSON lines, plus ``--device {cuda,cpu}``.
``--pm2-size`` (one value a refinement level, outermost first) and
``--pmx-size`` imply ``--pm``, and so does ``--pm-persist`` (the
persistent cell-sorted PM state, ops/pm_persist.py).

``--mesh auto`` shards the particles over a torch.distributed group, one
process a device (engine ``mesh``, parallel/): under ``torchrun`` it joins
torchrun's group; without one, ``--device cuda`` starts one rank a
visible GPU (torch.multiprocessing; in this process when there is one
GPU) and ``--device cpu`` runs a world of one. Every rank steps, renders
and checkpoints together; rank 0 alone writes the files and prints.

Examples:
    python -m particle_sim_tpu_torch.app.cli --device cuda \
        --count 1000000 --steps 600 --drag --orbit-mouse --color-mode 1 \
        --render-every 100 --render-dir frames/
    python -m particle_sim_tpu_torch.app.cli --device cuda --pairwise \
        --central-mass 1000 --count 65536 --steps 200 --renderer sorted \
        --render-every 100
    python -m particle_sim_tpu_torch.app.cli --device cuda --count 1000000 \
        --steps 600 --pm --pm-auto-box --pairwise-g 0.08 --dt 0.004 \
        --diagnostics
    python -m particle_sim_tpu_torch.app.cli --device cuda --count 1000000 \
        --steps 300 --pm --pm2-size 24 --pm2-softening 0.8 --pmx-size 6 \
        --pmx-softening 0.1
    python -m particle_sim_tpu_torch.app.cli --device cuda --count 1000000 \
        --steps 200 --pm-persist --central-mass 1000
    torchrun --standalone --nproc_per_node 4 \
        -m particle_sim_tpu_torch.app.cli --device cuda --mesh auto \
        --count 16777216 --steps 100 --pm --pm-persist
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
                   help="auto: shard the particles over the ranks of "
                        "torchrun's group, else over every visible GPU "
                        "(--device cuda) or a world of one (--device cpu)")
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
                        "body for --pairwise/--pm runs)")
    # particle-mesh solver (O(N) self-gravity; implies --pairwise physics)
    p.add_argument("--pm", action="store_true",
                   help="solve the gravity with the particle-mesh FFT "
                        "solver (millions of particles per frame)")
    p.add_argument("--pm-grid", type=int, default=128,
                   help="cells per axis (kernels: 32, 64, 128, 256)")
    p.add_argument("--pm-softening", type=float, default=2.0,
                   help="Plummer eps of the PM solver; keep >= ~2 cell "
                        "sizes")
    p.add_argument("--pm-box", type=float, nargs=4,
                   default=[-64.0, -64.0, -64.0, 128.0],
                   metavar=("XMIN", "YMIN", "ZMIN", "SIZE"))
    p.add_argument("--pm-boundary", choices=["isolated", "periodic"],
                   default="isolated")
    p.add_argument("--pm-auto-box", action="store_true",
                   help="track the cloud with a box recomputed every step "
                        "(--pm-softening is then in CELL units)")
    p.add_argument("--pm-gradient", choices=["exact", "fd"], default="exact")
    p.add_argument("--no-two-tier", action="store_true",
                   help="the JAX package's persistent-PM repair strategy: "
                        "full sort only (kept on the engine and in "
                        "checkpoints; every repair of the port is the full "
                        "sort)")
    # refinement levels (ops/pm2.py) and the exact window (ops/pmx.py)
    p.add_argument("--pm2-size", type=float, nargs="+", default=[0.0],
                   help="refinement-window extent(s), outermost first "
                        "(several values nest levels); implies --pm")
    p.add_argument("--pm2-window", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"),
                   help="static origin of the outermost window (default: "
                        "track the mass centroid)")
    p.add_argument("--pm2-softening", type=float, nargs="+", default=[0.5],
                   help="fine softening, one a --pm2-size level")
    p.add_argument("--pm2-margin", type=float, default=0.0)
    p.add_argument("--pmx-size", type=float, default=0.0,
                   help="window-exact short-range forces in a tracked "
                        "window of this size; implies --pm")
    p.add_argument("--pmx-softening", type=float, default=0.1)
    p.add_argument("--pmx-capacity", type=int, default=65536)
    p.add_argument("--pm-persist", action="store_true",
                   help="the persistent cell-sorted PM state (implies --pm; "
                        "needs a static box)")
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mesh == "auto" and not args.resume:
        return _main_mesh(args, argv)
    return _run(args)


def _main_mesh(args, argv) -> int:
    """--mesh auto: join or start the process group, run every rank."""
    import torch
    import torch.distributed as dist

    from ..parallel import distributed

    if not (dist.is_initialized() or distributed.launched_by_env()):
        if args.device == "cuda" and torch.cuda.device_count() > 1:
            import tempfile

            import torch.multiprocessing as mp

            n = torch.cuda.device_count()
            argv = sys.argv[1:] if argv is None else list(argv)
            with tempfile.TemporaryDirectory(prefix="psim_mesh_") as tmp:
                mp.spawn(_spawned_rank, nprocs=n, join=True, args=(
                    argv, n, "file://" + os.path.join(tmp, "store")))
            return 0
        owned = True
        distributed.initialize_single(args.device)
    else:
        owned = not dist.is_initialized()
        distributed.initialize(device=args.device)
    try:
        return _run(args, mesh=distributed.global_mesh(args.device))
    finally:
        if owned:
            distributed.shutdown()


def _spawned_rank(rank: int, argv, world: int, init_method: str) -> None:
    """One rank of ``--mesh auto --device cuda`` without torchrun."""
    from ..parallel import distributed

    args = build_parser().parse_args(argv)
    distributed.initialize(init_method, world, rank, device="cuda")
    try:
        _run(args, mesh=distributed.global_mesh("cuda"))
    finally:
        distributed.shutdown()


def _run(args, mesh=None) -> int:
    import torch

    from ..core.params import (
        Method, PairwiseParams, PMConfig, SimParams, SphereGeneration,
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
            ("--mesh", args.mesh != "none"), ("--count", args.count),
            ("--pm", args.pm), ("--pm-persist", args.pm_persist),
            ("--pairwise", args.pairwise),
            ("--no-two-tier", args.no_two_tier),
            ("--substeps", args.substeps != 1),
            ("--generation", args.generation != "hollow"),
        ) if given]
        if ignored:
            print(f"note: {', '.join(ignored)} ignored on --resume "
                  "(the checkpoint's configuration wins)", file=sys.stderr)
    else:
        # --pm-persist / --pm2-size / --pmx-size are PM solver modes:
        # they imply --pm
        if args.pm_persist or args.pm2_size[0] > 0.0 or args.pmx_size > 0.0:
            args.pm = True
        pm_cfg = None
        if args.pm:
            pm_cfg = PMConfig(
                grid=args.pm_grid,
                box_min=tuple(args.pm_box[:3]), box_size=args.pm_box[3],
                softening=args.pm_softening,
                boundary=args.pm_boundary, gradient=args.pm_gradient,
                auto_box=args.pm_auto_box)
        pm2_cfg = None
        if args.pm2_size[0] > 0.0:
            from ..ops.pm2 import PM2Config
            sizes, softs = args.pm2_size, args.pm2_softening
            if len(sizes) > 1 and len(softs) != len(sizes):
                raise SystemExit(
                    "--pm2-softening needs one value per --pm2-size level "
                    f"({len(sizes)} sizes, {len(softs)} softenings)")
            levels = tuple(PM2Config(
                window_min=(tuple(args.pm2_window)
                            if k == 0 and args.pm2_window else None),
                window_size=sz,
                softening=softs[min(k, len(softs) - 1)],
                margin=args.pm2_margin)
                for k, sz in enumerate(sizes))
            pm2_cfg = levels if len(levels) > 1 else levels[0]
        pmx_cfg = None
        if args.pmx_size > 0.0:
            from ..ops.pmx import PMXConfig
            pmx_cfg = PMXConfig(window_size=args.pmx_size,
                                softening=args.pmx_softening,
                                capacity=args.pmx_capacity)
        engine = Engine(
            particle_count=args.count,
            method=method,
            generation_mode=(SphereGeneration.HOLLOW
                             if args.generation == "hollow"
                             else SphereGeneration.FILLED),
            device=args.device,
            substeps=args.substeps,
            pairwise=(PairwiseParams(
                args.pairwise_g,
                args.pm_softening if args.pm else args.pairwise_softening)
                      if (args.pairwise or args.pm) else None),
            pm=pm_cfg,
            pm2=pm2_cfg,
            pmx=pmx_cfg,
            # bare --pm keeps "auto": Engine.PERSIST_AUTO_MIN_N decides
            pm_persist=True if args.pm_persist else "auto",
            two_tier=not args.no_two_tier,
            mesh=mesh,
        )
    writer = engine.rank == 0     # on a mesh rank 0 writes and prints
    if engine.mesh is not None and writer:
        print(f"mesh: dp over {engine.mesh.size()} devices", file=sys.stderr)

    if args.central_mass > 0.0:
        # applies to fresh AND resumed runs (overrides checkpoint masses)
        m = np.ones(engine.particle_count, np.float32)
        m[0] = args.central_mass
        engine.set_masses(m)

    camera = Camera(aspect=args.width / args.height)
    if args.render_every and writer:
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
            if writer:
                write_png(path, img)
                print(f"wrote {path}", file=sys.stderr)

        if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            ckpt.save(args.checkpoint, engine, step_index=i + 1)
            if writer:
                print(f"checkpointed -> {args.checkpoint}", file=sys.stderr)

        if args.stats_every and (i + 1) % args.stats_every == 0:
            line = {"step": i + 1, **engine.stats.snapshot()}
            if args.diagnostics:
                d = engine.diagnostics(potential=(args.pairwise or args.pm))
                if ((args.pairwise or args.pm) and d.potential is None
                        and i + 1 <= args.stats_every and writer):
                    print("note: potential unavailable (N too large for "
                          "the direct sum and no PM config: use --pm)",
                          file=sys.stderr)
                line.update(d.as_dict())
            if writer:
                print(json.dumps(line))

    # final sync so the last step's cost is visible
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.perf_counter() - t_start
    total = args.steps * engine.substeps * engine.particle_count
    if not writer:
        return 0
    print(json.dumps({
        "done": True, "steps": args.steps, "wall_s": round(wall, 3),
        "particle_steps_per_sec": round(total / wall, 1),
        **engine.stats.snapshot(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
