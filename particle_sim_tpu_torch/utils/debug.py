"""Debug checks: state validation and a finiteness check of a step's outputs.

Counterpart of ``particle_sim_tpu/utils/debug.py``:

  * :func:`validate_state`: one reduction on the state's device (finite
    positions, finite velocities, max |pos|, max |vel|), then one read of
    the four numbers; raises :class:`StateValidationError` naming what
    failed, with the JAX package's messages.
  * :func:`checked_step`: wraps a stepper so that it also returns a
    verdict on every floating tensor it returns, decided on the device
    and read once, when ``throw()`` is called.

``Engine(debug_checks=True)`` runs :func:`validate_state` after every
step. The CUDA kernels have no interpret mode: their debugging path is
the plain version each wrapper takes for CPU tensors (``device="cpu"``).
"""

from __future__ import annotations

from typing import List

import torch


class StateValidationError(RuntimeError):
    pass


def _report(pos: torch.Tensor, vel: torch.Tensor) -> torch.Tensor:
    """f32[4] on the state's device: pos finite, vel finite (1 or 0),
    max |pos|, max |vel|."""
    return torch.stack([torch.isfinite(pos).all().to(torch.float32),
                        torch.isfinite(vel).all().to(torch.float32),
                        pos.abs().amax().to(torch.float32),
                        vel.abs().amax().to(torch.float32)])


def validate_state(pos: torch.Tensor, vel: torch.Tensor, *,
                   max_abs_pos: float = 1e6,
                   max_abs_vel: float = 1e6) -> None:
    """Raise StateValidationError on NaN/Inf or runaway magnitudes."""
    pos_ok, vel_ok, pos_max, vel_max = _report(pos, vel).tolist()
    problems = []
    if not pos_ok:
        problems.append("non-finite positions")
    if not vel_ok:
        problems.append("non-finite velocities")
    if pos_max > max_abs_pos:
        problems.append(f"position magnitude {pos_max:.3g} > {max_abs_pos:g}")
    if vel_max > max_abs_vel:
        problems.append(f"velocity magnitude {vel_max:.3g} > {max_abs_vel:g}")
    if problems:
        raise StateValidationError("; ".join(problems))


def _float_leaves(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _float_leaves(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _float_leaves(o)]
    return []


class CheckedError:
    """The verdict of one :func:`checked_step` call: bool[k] on the
    device, one entry a floating output, True where it holds a NaN or an
    infinity. Reading it waits for the step."""

    def __init__(self, bad: torch.Tensor):
        self.bad = bad

    def get(self) -> str:
        """'' when every output is finite, else which ones are not."""
        idx = [i for i, b in enumerate(self.bad.tolist()) if b]
        if not idx:
            return ""
        return f"non-finite value in floating output(s) {idx}"

    def throw(self) -> None:
        msg = self.get()
        if msg:
            raise StateValidationError(msg)


def checked_step(step_fn):
    """Wrap a stepper: ``fn(*args) -> (error, out)``; ``error.throw()``
    raises StateValidationError when a floating output of ``step_fn``
    holds a NaN or an infinity.

    The counterpart of checkify's ``float_checks`` in the JAX package,
    with one difference of scope: it checks the OUTPUTS (every floating
    tensor in the returned tuples, lists and dicts), not the
    intermediate values inside a kernel or an op, so a NaN that a later
    operation masks away is not reported."""

    def fn(*args, **kw):
        out = step_fn(*args, **kw)
        leaves = _float_leaves(out)
        if not leaves:
            return CheckedError(torch.zeros(0, dtype=torch.bool)), out
        bad = torch.stack([~torch.isfinite(t).all() for t in leaves])
        return CheckedError(bad), out

    return fn
