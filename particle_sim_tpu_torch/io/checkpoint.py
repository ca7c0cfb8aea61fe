"""Checkpoint / resume.

Counterpart of ``particle_sim_tpu/io/checkpoint.py`` with the same file
format (``FORMAT_VERSION = 1``: one .npz holding positions, velocities
and init colors sliced to the active count, and a JSON ``meta`` with the
same keys), so a file saved by either package loads in the other. A
checkpoint whose configuration needs a part not ported yet (a gravity
solver, masses) raises ``NotImplementedError`` on load.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..core.params import Method, SphereGeneration
from ..core.state import ParticleState
from ..engine import Engine
from ..engine.engine import not_ported

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
        # the attractor configuration: no gravity solver
        "pairwise": None,
        "pm": None,
        "pm_persist": "auto",
        "pm2": None,
        "pmx": None,
        "two_tier": True,
    }
    arrays = dict(
        positions=state.positions(),
        velocities=state.velocities(),
        init_colors=state.init_color.reshape(3, -1)[:, :n].cpu().numpy().T,
        meta=json.dumps(meta),
    )
    # atomic: an interruption mid-save must not truncate the previous
    # good checkpoint
    tmp = f"{path}.tmp"
    np.savez_compressed(tmp, **arrays)
    actual = tmp if os.path.exists(tmp) else tmp + ".npz"  # np may append
    os.replace(actual, path)


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
        has_masses = "masses" in z.files

    for key in ("pairwise", "pm", "pm2", "pmx"):
        if meta.get(key):
            raise not_ported(key)
    if meta.get("pm_persist") is True:
        raise not_ported("pm_persist")
    if has_masses:
        raise not_ported("masses")
    engine = Engine(
        particle_count=1,  # placeholder; the state is replaced below
        method=method if method is not None else Method(meta["method"]),
        generation_mode=SphereGeneration(meta["generation_mode"]),
        device=device,
        substeps=meta.get("substeps", 1),
    )
    engine.state = ParticleState.from_arrays(positions, velocities,
                                             init_colors, device=device)
    engine.paused = bool(meta["paused"])
    return engine, int(meta["step_index"])
