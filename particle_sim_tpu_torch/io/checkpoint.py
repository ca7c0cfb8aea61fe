"""Checkpoint / resume.

Counterpart of ``particle_sim_tpu/io/checkpoint.py`` with the same file
format (``FORMAT_VERSION = 1``: one .npz holding positions, velocities
and init colors sliced to the active count, an optional ``masses``
array, and a JSON ``meta`` with the same keys, ``pairwise`` and ``pm``
included, and ``pm2``: one dict or a list of dicts, outermost level
first, ``pmx`` and ``pm_persist``), so a file saved by either package
loads in the other. The state is saved in identity order (the engine's
``state`` rebuilds it from the persistent PM's sorted mirror). A mesh
engine's state and masses are gathered from every rank (all ranks call
:func:`save`), and rank 0 writes the file.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from ..core.params import Method, PairwiseParams, PMConfig, SphereGeneration
from ..core.state import ParticleState
from ..engine import Engine
from ..ops.pm2 import PM2Config
from ..ops.pmx import PMXConfig

FORMAT_VERSION = 1


def save(path: str, engine: Engine, step_index: int = 0) -> None:
    state = engine.state
    n = engine.particle_count
    meta = {
        "format_version": FORMAT_VERSION,
        "generation_mode": int(engine.generation_mode),
        "method": int(engine.method),
        "paused": engine.paused,
        "step_index": step_index,
        "substeps": engine.substeps,
        "pairwise": (
            [engine.pairwise.gravitational_constant, engine.pairwise.softening]
            if engine.pairwise else None),
        "pm": dataclasses.asdict(engine.pm) if engine.pm else None,
        # the raw mode ("auto" | True | False), not its resolution
        "pm_persist": engine.pm_persist,
        # one PM2Config -> a dict; a multi-level tuple -> a list of dicts
        "pm2": ([dataclasses.asdict(c) for c in engine.pm2]
                if isinstance(engine.pm2, tuple)
                else dataclasses.asdict(engine.pm2) if engine.pm2 else None),
        "pmx": dataclasses.asdict(engine.pmx) if engine.pmx else None,
        "two_tier": engine.two_tier,
    }
    arrays = dict(
        positions=state.positions(),
        velocities=state.velocities(),
        init_colors=state.init_color.reshape(3, -1)[:, :n].cpu().numpy().T,
        meta=json.dumps(meta),
    )
    masses = engine.masses     # repadded to the current capacity
    if masses is not None:
        arrays["masses"] = masses[:n].cpu().numpy()
    if engine.rank != 0:
        return
    # atomic: an interruption mid-save must not truncate the previous
    # good checkpoint
    tmp = f"{path}.tmp"
    np.savez_compressed(tmp, **arrays)
    actual = tmp if os.path.exists(tmp) else tmp + ".npz"  # np may append
    os.replace(actual, path)


def _config(cls, d: dict):
    """A PM2Config / PMXConfig from its saved dict (``window_min`` back
    to a tuple)."""
    if d.get("window_min") is not None:
        d = dict(d, window_min=tuple(d["window_min"]))
    return cls(**d)


def load(path: str, method: Optional[Method] = None, *,
         device="cuda") -> tuple:
    """-> (Engine, step_index). ``method`` overrides the saved one."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["format_version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version: {meta}")
        positions = z["positions"]
        velocities = z["velocities"]
        init_colors = z["init_colors"]
        masses = z["masses"] if "masses" in z.files else None

    pm_persist = meta.get("pm_persist", False)
    pair = meta.get("pairwise")
    pm_meta = meta.get("pm")
    if pm_meta:
        pm_meta["box_min"] = tuple(pm_meta["box_min"])
    pm2_meta, pmx_meta = meta.get("pm2"), meta.get("pmx")
    pm2_cfg = None
    if pm2_meta:
        pm2_cfg = (tuple(_config(PM2Config, d) for d in pm2_meta)
                   if isinstance(pm2_meta, list)
                   else _config(PM2Config, pm2_meta))
    engine = Engine(
        particle_count=1,  # placeholder; the state is replaced below
        method=method if method is not None else Method(meta["method"]),
        generation_mode=SphereGeneration(meta["generation_mode"]),
        device=device,
        substeps=meta.get("substeps", 1),
        pairwise=PairwiseParams(*pair) if pair else None,
        pm=PMConfig(**pm_meta) if pm_meta else None,
        pm2=pm2_cfg,
        pmx=_config(PMXConfig, pmx_meta) if pmx_meta else None,
        pm_persist=pm_persist,
        two_tier=meta.get("two_tier", True),
    )
    engine.state = ParticleState.from_arrays(positions, velocities,
                                             init_colors, device=device)
    if masses is not None:
        engine.set_masses(masses)
    engine.paused = bool(meta["paused"])
    return engine, int(meta["step_index"])
