"""The one traffic generator: it reads a mix (``traffic/<mix>.json``) and
drives the program with it. Two kinds of mix:

  * ``headless``: runs of ``steps_per_run`` steps through ``Engine.step``,
    as ``app/cli.py`` drives it (a stats line every ``stats_every`` steps,
    with ``Engine.diagnostics`` where ``diagnostics`` is set; no frames).
    Runs follow one another through the window, each restarting from the
    seed's initial state through the ``engine.state`` setter, so the
    sorted mirror is rebuilt as a user's run starts. The window ends
    with a device synchronisation; a run that it cuts counts the steps it
    completed.
  * ``served``: the stream server (``app/server.py``'s ``make_server``,
    built from the configuration's documented flags and the mix's wire
    flags) in this process on a free loopback port, and one viewer in a
    process of its own (``client.py``, a WebSocket client). The viewer
    sends the configuration's set-up events, then ``camera`` poses along
    an orbit, open loop: the gaps are the
    quantiles of an exponential distribution of mean ``mean_gap_s``,
    scaled to fill the window and put in an order drawn from the seed, so
    every seed sends the same events at the same gaps in another order.
    The window opens once warm-up is done, a few hundred steps past the
    collapse of the seed's sphere (a window from the seed's state itself
    spread more from run to run, PERF.md). An event that no frame's
    ``reflected_seq`` reaches has failed.

Both make their initial state from the seed (``state.py``) and install it
through the engine's setters, warm up every shape the window uses (that
time counts as set-up), measure for ``seconds``, and then have the
program produce the outputs that ``check.py`` judges.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import check, state
from . import trace as tracing
from . import wsclient

LANE = state.LANE
#: The wire header's mode of a raster frame (app/server.py).
RASTER_MODE = 2


# -- the program's side ------------------------------------------------------------
#: Flags of app/cli.py that the headless generator does not drive.
CLI_UNDRIVEN = ("resume", "orbit_mouse", "render_every", "checkpoint_every")


def cli_args(config: dict, device):
    """The configuration's documented command (``cli_argv``) as
    ``app/cli.py``'s own parser reads it, on ``device``."""
    from particle_sim_tpu_torch.app import cli

    args = cli.build_parser().parse_args(
        [*config["cli_argv"], "--device", str(device)])
    undriven = [k for k in CLI_UNDRIVEN if getattr(args, k)]
    if undriven or args.mesh != "none":
        raise ValueError(f"cli_argv sets {undriven or ['mesh']}, which the "
                         "headless generator does not drive")
    return args


def build_engine(args):
    """The engine ``app/cli.py``'s ``_run`` builds from its arguments
    (a fresh run: the PM modes imply ``--pm``; the pairwise softening is
    the PM's under ``--pm``). Its central mass is the state's
    (``installer``)."""
    from particle_sim_tpu_torch.core.params import (
        Method, PairwiseParams, PMConfig, SphereGeneration,
    )
    from particle_sim_tpu_torch.engine import Engine

    pm = args.pm or args.pm_persist or args.pm2_size[0] > 0.0 \
        or args.pmx_size > 0.0
    pm_cfg = pm2_cfg = pmx_cfg = None
    if pm:
        pm_cfg = PMConfig(
            grid=args.pm_grid, box_min=tuple(args.pm_box[:3]),
            box_size=args.pm_box[3], softening=args.pm_softening,
            boundary=args.pm_boundary, gradient=args.pm_gradient,
            auto_box=args.pm_auto_box)
    if args.pm2_size[0] > 0.0:
        from particle_sim_tpu_torch.ops.pm2 import PM2Config

        sizes, softs = args.pm2_size, args.pm2_softening
        levels = tuple(PM2Config(
            window_min=(tuple(args.pm2_window)
                        if k == 0 and args.pm2_window else None),
            window_size=sz, softening=softs[min(k, len(softs) - 1)],
            margin=args.pm2_margin) for k, sz in enumerate(sizes))
        pm2_cfg = levels if len(levels) > 1 else levels[0]
    if args.pmx_size > 0.0:
        from particle_sim_tpu_torch.ops.pmx import PMXConfig

        pmx_cfg = PMXConfig(window_size=args.pmx_size,
                            softening=args.pmx_softening,
                            capacity=args.pmx_capacity)
    return Engine(
        particle_count=args.count,
        method={"auto": None, "torch": Method.TORCH,
                "cuda": Method.CUDA}[args.method],
        generation_mode=(SphereGeneration.HOLLOW
                         if args.generation == "hollow"
                         else SphereGeneration.FILLED),
        device=args.device, substeps=args.substeps,
        pairwise=(PairwiseParams(
            args.pairwise_g,
            args.pm_softening if pm else args.pairwise_softening)
                  if (args.pairwise or pm) else None),
        pm=pm_cfg, pm2=pm2_cfg, pmx=pmx_cfg,
        pm_persist=True if args.pm_persist else "auto",
        two_tier=not args.no_two_tier)


def sim_params(args):
    """The step's parameters ``_run`` passes for its arguments."""
    from particle_sim_tpu_torch.core.params import SimParams

    return SimParams(
        delta_time=args.dt, gravity=args.gravity,
        color_mode=args.color_mode, mouse_force=args.mouse_force,
        mouse_radius=args.mouse_radius, is_mouse_dragging=args.drag,
        damping=args.damping, max_dist_for_color=args.max_dist_for_color,
        mouse_position=tuple(args.mouse_pos))


def installer(engine, init: state.Initial):
    """-> restart(): install the seed's initial state (fresh copies of
    its planes) through the ``engine.state`` setter."""
    from particle_sim_tpu_torch.core.state import ParticleState

    rows = init.pos.shape[1] // LANE
    n_active = torch.tensor(init.n, dtype=torch.int32, device=init.pos.device)

    def restart():
        engine.state = ParticleState(
            pos=init.pos.clone().view(3, rows, LANE),
            vel=init.vel.clone().view(3, rows, LANE),
            init_color=init.col.view(3, rows, LANE), n_active=n_active)

    restart()
    if init.masses is not None:
        engine.set_masses(init.masses[:init.n].cpu().numpy())
    return restart


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def _start_trace(run):
    if not run.trace_on:
        return None
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(run.device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # the server's threads launch work too: profile every thread
    from torch._C._profiler import _ExperimentalConfig

    prof = torch.profiler.profile(
        activities=acts,
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    return prof


def _stop_trace(run, prof, t0_ns: int, t1_ns: int) -> None:
    if prof is None:
        return
    prof.stop()
    run.trace = tracing.view_from_profiler(prof, t0_ns, t1_ns)


# -- headless ---------------------------------------------------------------------------
def headless(run) -> None:
    cfg, tr = run.config, run.traffic
    args = cli_args(cfg, run.device)
    eng = build_engine(args)
    init = state.initial(cfg, run.seed, run.device)
    restart = installer(eng, init)
    params = sim_params(args)
    if run.trace_on:
        run.spans.wrap(eng, "step", "Engine.step")
        run.spans.wrap(eng, "diagnostics", "Engine.diagnostics")
    per_run, every = int(tr["steps_per_run"]), int(tr["stats_every"])
    diag = bool(tr["diagnostics"])

    def stats_line(i):
        # the CLI's stats line: its reads and its diagnostics are the work
        line = {"step": i, **eng.stats.snapshot()}
        if diag:
            line.update(eng.diagnostics(potential=True).as_dict())
        return json.dumps(line)

    # warm-up: a restart, the steps of a verdict cycle and a stats line
    restart()
    for _ in range(int(tr["warmup_steps"])):
        eng.step(params)
    stats_line(0)
    _sync(run.device)

    run.setup_s = time.perf_counter() - run.t_process
    if run.trace_on:
        # one run of the mix with the profiler off: the host's own
        # dispatch, which the profiler inflates (``run.untraced``)
        run.spans.profiled, run.spans.recording = False, True
        restart()
        for i in range(per_run):
            eng.step(params)
            if every and (i + 1) % every == 0:
                stats_line(i + 1)
        _sync(run.device)
        run.spans.recording, run.spans.profiled = False, True
        run.untraced = run.spans.take()
    prof = _start_trace(run)
    run.spans.recording = True
    steps = resorts = 0
    t0, t0_ns = time.perf_counter(), time.time_ns()
    deadline = t0 + run.seconds
    cut = False
    while not cut:
        restart()
        for i in range(per_run):
            eng.step(params)
            steps += 1
            if every and (i + 1) % every == 0:
                stats_line(i + 1)
            if time.perf_counter() >= deadline:
                cut = True
                break
        resorts += eng.resorts
    _sync(run.device)
    t1, t1_ns = time.perf_counter(), time.time_ns()
    run.spans.recording = False
    run.window_s, run.steps = t1 - t0, steps
    run.attempted, run.failed = steps, 0
    run.counters["resorts"] = resorts
    run.memory_peak = _memory_peak(run.device)
    _stop_trace(run, prof, t0_ns, t1_ns)

    outs = check.Outputs()
    check.program_steps(eng, restart, params, init.n,
                        int(run.cell["check"]["steps"]), diag, outs)
    run.outputs, run.init = outs, init
    run.params = dataclasses.asdict(params)


# -- served ------------------------------------------------------------------------------
def server_argv(config: dict, tr: dict, device) -> list:
    argv = list(config["server_argv"])
    argv += ["--fps", str(tr["fps"]), "--view-mode", "raster",
             "--raster-size", tr["raster_size"]]
    return argv + ["--device", str(device), "--host", "127.0.0.1",
                   "--port", "0"]


def _frame_check(server, payload, init, seq: int, outs) -> None:
    """The raster wire frame of the paused state, its header's faults,
    and the state, camera and parameters it was drawn from."""
    eng, n = server.engine, init.n
    with server.lock:
        st = eng.state
        w, h = server.raster_size
        outs.view = {
            "pos": st.pos.reshape(3, -1)[:, :n].clone(),
            "vel": st.vel.reshape(3, -1)[:, :n].clone(),
            "col": init.col[:, :n], "params": dataclasses.asdict(server.params),
            "view_proj": server.camera.view_proj(), "width": w, "height": h,
        }
    if payload is None:
        outs.header_faults = 1
        return
    hdr = wsclient.Header(*struct.unpack_from(wsclient.HEADER_FMT, payload))
    body = memoryview(payload)[wsclient.HEADER_BYTES:]
    fw, fh = (int(v) for v in np.frombuffer(body[:8], dtype="<u4"))
    ok = len(body) == 8 + 4 * fw * fh
    faults = [hdr.magic != wsclient.MAGIC, hdr.mode != RASTER_MODE,
              hdr.total != n, not hdr.flags & wsclient.FLAG_PAUSED,
              hdr.reflected_seq != seq,
              not (math.isfinite(hdr.input_to_frame_ms)
                   and hdr.input_to_frame_ms >= 0.0),
              (fw, fh) != (w, h), hdr.count != w * h, not ok]
    if ok:
        outs.frame = torch.from_numpy(np.frombuffer(
            body[8:], dtype=np.uint8).reshape(fh, fw, 4).copy()).to(
                init.pos.device)
    outs.header_faults = int(sum(bool(f) for f in faults))


def _readline(proc, want: str) -> str:
    line = proc.stdout.readline()
    if not line.startswith(want):
        raise RuntimeError(f"the viewer process said {line!r}, not {want!r}")
    return line


def served(run) -> None:
    from particle_sim_tpu_torch.app import server as srv

    cfg, tr = run.config, run.traffic
    server = srv.make_server(server_argv(cfg, tr, run.device))
    eng = server.engine
    init = state.initial(cfg, run.seed, run.device)
    restart = installer(eng, init)
    if run.trace_on:
        run.spans.wrap(eng, "step", "Engine.step")
        run.spans.wrap(eng, "render_frame_device",
                       "Engine.render_frame_device")
        run.spans.wrap(eng, "frame_arrays_device",
                       "Engine.frame_arrays_device")
    tmp = tempfile.mkdtemp(prefix="bench_viewer_")
    files = {"paused_file": os.path.join(tmp, "paused.bin"),
             "result_file": os.path.join(tmp, "result.json")}
    server.start()
    proc = None
    try:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(os.path.dirname(__file__),
                                          "client.py")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        proc.stdin.write(json.dumps({
            "port": server.port, "seed": run.seed, "seconds": run.seconds,
            **{k: tr[k] for k in ("orbit", "mean_gap_s",
                                  "warmup_s")}, **files}) + "\n")
        proc.stdin.flush()
        _readline(proc, "ready")
        run.setup_s = time.perf_counter() - run.t_process
        prof = _start_trace(run)
        run.spans.recording = True
        proc.stdin.write("go\n")
        proc.stdin.flush()
        t0 = float(_readline(proc, "t0").split()[1])
        t0_ns = time.time_ns() - int((time.perf_counter() - t0) * 1e9)
        end = t0 + run.seconds
        if end > time.perf_counter():
            time.sleep(end - time.perf_counter())
        t1, t1_ns = time.perf_counter(), time.time_ns()
        run.spans.recording = False
        run.memory_peak = _memory_peak(run.device)
        _stop_trace(run, prof, t0_ns, t1_ns)
        run.window_s = t1 - t0
        _readline(proc, "done")
        proc.wait(60)
        with open(files["result_file"]) as f:
            res = json.load(f)
        payload = None
        if os.path.exists(files["paused_file"]):
            with open(files["paused_file"], "rb") as f:
                payload = f.read()
        _events(run, res, t0, t1)
        outs = check.Outputs()
        _frame_check(server, payload, init, res["last_seq"], outs)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(60)
        server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    eng.set_paused(False)
    check.program_steps(eng, restart, server.params, init.n,
                        int(run.cell["check"]["steps"]), False, outs)
    run.outputs, run.init = outs, init
    run.params = dataclasses.asdict(server.params)


def _events(run, res: dict, t0: float, t1: float) -> None:
    """The window's events (an event no frame reflects has failed), the
    distinct frames received in the window, and how late the viewer sent
    its events (95th percentile)."""
    frames = [(f[0], wsclient.Header(*f[1:])) for f in res["frames"]]
    dues, first = res["dues"], int(res["first"])
    reflected = max((h.reflected_seq for _, h in frames), default=-1)
    run.attempted = len(dues)
    run.failed = sum(1 for k in range(len(dues)) if first + k > reflected)
    run.frames_in_window = len({h.frame_id for t, h in frames
                                if t0 <= t < t1})
    late = sorted(res["late"])
    if late:
        run.generator_late_ms = late[int(0.95 * (len(late) - 1))] * 1e3


DRIVERS = {"headless": headless, "served": served}
