"""How ``correct`` is decided: the program's outputs against the plain
reference (``reference/<name>.py``), each number held to its limit in
the cell's file (``workloads/<cell>.json``, ``check.limits``).

What the program produced, once the window has closed:

  * ``start``: the engine's first ``steps`` steps from the seeded state,
    through the window's own call (``Engine.step``), with the window's
    parameters. The reference takes the same seeded planes.
  * ``end``: ``steps`` more steps of the same engine from the state the
    window left (the persistent PM's sorted mirror as it stood, repairs
    and all): the reference follows them from that state, which it reads
    only as the input of those steps.
  * ``diag``: ``Engine.diagnostics(potential=True)`` on the state ``end``
    reached, where the traffic takes diagnostics.
  * ``frame``: the raster payload of the paused wire frame the client
    received (the state, the camera and the parameters it was drawn
    from), and the header faults of that frame.

The numbers: ``<stage>.pos_gap``, the largest position gap in cells;
``<stage>.vel_gap``, the largest velocity gap over the largest velocity
change of the reference over the steps; where the cell reads a stage by
"vs_f32", ``<stage>.pos_vs_f32`` and ``<stage>.vel_vs_f32`` in their
place: each particle's gap over the gap of the reference computed in
float32 from the same input, at the 99.999th percentile (``STATS``); ``diag.*_gap``, relative gaps of
the energies and of the momentum (against the sum of m |v|);
``frame.gap_u8``, the largest gap of a frame channel in u8 steps;
``wire.header_faults``.
"""

from __future__ import annotations

import importlib
import math
from typing import Optional

import torch

#: Stand-in printed for a gap that is not finite (JSON has no inf/NaN).
NOT_FINITE = 1.0e30


def reference_module(config: dict):
    return importlib.import_module(f"benchmark.reference.{config['reference']}")


def _finite(x: float) -> float:
    return x if math.isfinite(x) else NOT_FINITE


def max_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.double() - b.double().to(a.device)).abs()
    if not bool(torch.isfinite(d).all()):
        return NOT_FINITE
    return float(d.max()) if d.numel() else 0.0


def _quantile(x: torch.Tensor, q: float) -> float:
    """The q-quantile (nearest rank) of a 1-D tensor of any length."""
    k = min(int(q * x.numel()), x.numel() - 1)
    return float(torch.kthvalue(x, k + 1).values)


#: The statistics a stage's gaps can be read by (``stats`` in a cell's
#: check): "max", the largest particle's gap; "vs_f32", each particle's
#: gap over the gap of the reference computed in float32 (the precision
#: the configurations state) from the same input, at the 99.999th
#: percentile of the particles.
STATS = ("max", "vs_f32")
#: The quantile of "vs_f32".
VS_F32_QUANTILE = 0.99999
#: Floors of the float32 reference's gaps in "vs_f32": 1e-5 cells, and
#: 1e-6 of the reference's largest velocity change (the start stage's
#: gaps at 16M: PERF.md).
FLOOR_POS_CELLS, FLOOR_VEL = 1e-5, 1e-6


def step_numbers(stage: str, out: tuple, ref: tuple, vel_in: torch.Tensor,
                 cell: float, stats=("max",),
                 witness: Optional[tuple] = None) -> dict:
    """Gaps of (pos, vel) after the steps against the reference's, per
    particle the largest component. "max": ``<stage>.pos_gap`` in cells
    and ``<stage>.vel_gap`` over the largest velocity change of the
    reference. "vs_f32": ``<stage>.pos_vs_f32`` and
    ``<stage>.vel_vs_f32``, each particle's gap over that of
    ``witness`` (the reference in float32; floored), at the 99.999th
    percentile."""
    (pos, vel), (rpos, rvel) = out, ref
    rvel = rvel.double()

    def gaps(p, v):
        return ((p.double().to(rpos.device) - rpos.double()).abs().amax(0),
                (v.double().to(rvel.device) - rvel).abs().amax(0))

    dx, dv = gaps(pos, vel)
    change = float((rvel - vel_in.double().to(rvel.device)).abs().max())
    finite = bool(torch.isfinite(dx).all() & torch.isfinite(dv).all())
    out_nums = {}
    if "max" in stats:
        out_nums[f"{stage}.pos_gap"] = _finite(float(dx.max()) / cell) \
            if finite else NOT_FINITE
        out_nums[f"{stage}.vel_gap"] = _finite(
            float(dv.max()) / max(change, 1e-30)) if finite else NOT_FINITE
    if "vs_f32" in stats:
        wx, wv = gaps(*witness)
        ratio_x = dx / torch.clamp_min(wx, FLOOR_POS_CELLS * cell)
        ratio_v = dv / torch.clamp_min(wv, FLOOR_VEL * max(change, 1e-30))
        for name, r in (("pos", ratio_x), ("vel", ratio_v)):
            out_nums[f"{stage}.{name}_vs_f32"] = (
                _finite(_quantile(r, VS_F32_QUANTILE))
                if finite and bool(torch.isfinite(r).all()) else NOT_FINITE)
    return out_nums


def diag_numbers(out: dict, ref: dict) -> dict:
    def rel(a, b, scale):
        return _finite(abs(float(a) - float(b)) / max(abs(scale), 1e-30))

    mom = math.sqrt(sum((float(p) - float(r)) ** 2
                        for p, r in zip(out["momentum"], ref["momentum"])))
    return {
        "diag.kinetic_gap": rel(out["kinetic"], ref["kinetic"],
                                ref["kinetic"]),
        "diag.potential_gap": rel(out["potential"], ref["potential"],
                                  ref["potential"]),
        "diag.momentum_gap": _finite(mom / max(ref["momentum_scale"],
                                               1e-30)),
    }


def frame_numbers(frame: torch.Tensor, ref: torch.Tensor) -> dict:
    return {"frame.gap_u8": max_gap(frame.to(torch.int16),
                                    ref.to(torch.int16))}


class Outputs:
    """What the program produced for the check (tensors on the card)."""

    def __init__(self):
        self.start_out: Optional[tuple] = None     # (pos, vel) [3, n]
        self.end_in: Optional[tuple] = None
        self.end_out: Optional[tuple] = None
        self.diag: Optional[dict] = None
        self.frame: Optional[torch.Tensor] = None  # u8 [H, W, 4]
        self.view: Optional[dict] = None           # state, camera, params
        self.header_faults: Optional[int] = None


def _live(planes, n: int) -> torch.Tensor:
    return planes.reshape(3, -1)[:, :n].clone()


def program_steps(engine, restart, params, n: int, steps: int,
                  diagnostics: bool, outs: Outputs) -> None:
    """Fill ``outs`` with the program's ``end`` and ``start`` stages:
    ``steps`` steps from the state the window left, the diagnostics
    there, then ``restart()`` and ``steps`` steps from the seed's."""
    st = engine.state
    outs.end_in = (_live(st.pos, n), _live(st.vel, n))
    for _ in range(steps):
        engine.step(params)
    st = engine.state
    outs.end_out = (_live(st.pos, n), _live(st.vel, n))
    if diagnostics:
        outs.diag = engine.diagnostics(potential=True).as_dict()
    restart()
    for _ in range(steps):
        engine.step(params)
    st = engine.state
    outs.start_out = (_live(st.pos, n), _live(st.vel, n))


def judge(config: dict, cell_check: dict, init, params: dict,
          outs: Outputs, device, with_control: bool = False) -> tuple:
    """(numbers, control numbers or None): the gaps of the program's
    outputs from the reference's and, with ``with_control``, those of
    the control (the reference a precision lower, in the program's
    place) from the same inputs. ``cell_check``: the cell's ``check``
    (``steps``, ``stats`` a stage, ``limits``)."""
    mod = reference_module(config)
    ref = mod.make(config, device)
    ctrl = mod.make(config, device, "bfloat16") if with_control else None
    steps, stats = int(cell_check["steps"]), cell_check["stats"]
    n = init.n
    masses = init.masses
    nums, cnums = {}, {}
    pos0, vel0 = init.pos[:, :n], init.vel[:, :n]
    for stage, p_in, v_in, out in (
            ("start", pos0, vel0, outs.start_out),
            ("end", *(outs.end_in or (None, None)), outs.end_out)):
        if out is None:
            continue
        rp, rv, cell = ref.steps(p_in, v_in, masses, params, steps)
        witness = None
        if "vs_f32" in stats[stage]:
            wp, wv, _ = mod.make(config, device, "float32").steps(
                p_in, v_in, masses, params, steps)
            witness = (wp, wv)
        nums.update(step_numbers(stage, out, (rp, rv), v_in, cell,
                                 stats[stage], witness))
        if ctrl is not None:
            cp, cv, _ = ctrl.steps(p_in, v_in, masses, params, steps)
            cnums.update(step_numbers(stage, (cp, cv), (rp, rv), v_in, cell,
                                      stats[stage], witness))
    if outs.diag is not None:
        rd = ref.diagnostics(*outs.end_out, masses)
        nums.update(diag_numbers(outs.diag, rd))
        if ctrl is not None:
            cnums.update(diag_numbers(ctrl.diagnostics(*outs.end_out,
                                                        masses), rd))
    view = outs.view
    if outs.frame is not None:
        args = (view["pos"], view["vel"], view["col"], view["params"],
                view["view_proj"], view["width"], view["height"])
        rf = ref.frame(*args)
        nums.update(frame_numbers(outs.frame, rf))
        if ctrl is not None:
            c8 = mod.make(config, device, "float8")
            cnums.update(frame_numbers(c8.frame(*args), rf))
    if outs.header_faults is not None:
        nums["wire.header_faults"] = float(outs.header_faults)
    missing = sorted(set(nums) - set(cell_check["limits"]))
    if missing:
        raise ValueError(f"numbers without a limit in the cell's file: "
                         f"{missing}")
    return nums, (cnums if ctrl is not None else None)


def verdict(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit."""
    rows = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    return all(v <= limits[k] for k, v in nums.items()), rows
