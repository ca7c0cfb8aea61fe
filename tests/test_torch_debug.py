"""The port's debug and profiling utilities (utils/debug.py,
utils/profiling.py, Engine(debug_checks=...), Engine(interpret=...),
tools/pm_profile.py): the port's side of tests/test_utils.py, with the
same planes given to the JAX package's validate_state for the same
verdict."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_sim_tpu.utils import debug as jdebug

from particle_sim_tpu_torch.core.params import Method, PMConfig, SimParams
from particle_sim_tpu_torch.core.state import ParticleState
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.ops import step_ref
from particle_sim_tpu_torch.tools import pm_profile
from particle_sim_tpu_torch.utils import debug, profiling

torch.set_num_threads(1)


def planes(fill_pos=0.0, fill_vel=0.0):
    return (torch.full((3, 8, 128), fill_pos), torch.full((3, 8, 128),
                                                          fill_vel))


class TestValidate:
    def test_clean_state_passes(self):
        e = Engine(particle_count=500, device="cpu")
        debug.validate_state(e.state.pos, e.state.vel)

    def test_nan_detected(self):
        pos, vel = planes(float("nan"))
        with pytest.raises(debug.StateValidationError, match="positions"):
            debug.validate_state(pos, vel)

    def test_runaway_detected(self):
        pos, vel = planes(0.0, 1e9)
        with pytest.raises(debug.StateValidationError, match="velocity"):
            debug.validate_state(pos, vel)

    def test_engine_debug_mode(self):
        e = Engine(particle_count=200, device="cpu", debug_checks=True)
        e.step(SimParams(gravity=1.0))          # a clean step passes
        pos = e.state.pos.clone()
        pos[0, 0, 0] = float("nan")
        e.state = ParticleState(pos=pos, vel=e.state.vel,
                                init_color=e.state.init_color,
                                n_active=e.state.n_active)
        with pytest.raises(debug.StateValidationError):
            e.step(SimParams())

    def test_engine_debug_mode_persistent(self):
        """With the persistent PM the check reads the sorted mirror (the
        identity planes are stale), so a NaN there raises too."""
        e = Engine(particle_count=1500, device="cpu",
                   pm=PMConfig(grid=32, softening=4.0), pm_persist=True,
                   debug_checks=True)
        e.step(SimParams(delta_time=0.016, gravity=0.0))
        assert e._identity_dirty
        e._persist.vel[0, 10] = float("nan")
        with pytest.raises(debug.StateValidationError, match="positions"):
            e.step(SimParams(delta_time=0.016, gravity=0.0))

    @pytest.mark.parametrize("pos_v, vel_v, pos_at", [
        (0.0, 0.0, None), (float("nan"), 0.0, None), (0.0, float("inf"), None),
        (2e6, 0.0, None), (0.0, -3e6, None), (float("nan"), 5e7, None),
        (1.0, 1.0, (1, 3, 7))])
    def test_same_verdict_as_jax(self, pos_v, vel_v, pos_at):
        """Both packages' validate_state on the same planes: both pass,
        or both raise the same message."""
        pos = np.full((3, 8, 128), 1.0, np.float32)
        vel = np.zeros((3, 8, 128), np.float32)
        pos[0, 2, 5], vel[2, 7, 100] = pos_v, vel_v
        if pos_at is not None:
            pos[pos_at] = float("inf")

        def verdict(validate, p, v):
            try:
                validate(p, v)
            except (debug.StateValidationError,
                    jdebug.StateValidationError) as exc:
                return str(exc)
            return None

        ours = verdict(debug.validate_state, torch.from_numpy(pos),
                       torch.from_numpy(vel))
        theirs = verdict(jdebug.validate_state, jnp.asarray(pos),
                         jnp.asarray(vel))
        assert ours == theirs
        assert (ours is None) == ((pos_v, vel_v, pos_at) == (0.0, 0.0, None))


class TestChecked:
    def test_checked_step_flags_nan(self):
        def bad_step(x):
            return x / (x - x)  # 1/0

        err, _ = debug.checked_step(bad_step)(torch.ones(4))
        assert err.get()
        with pytest.raises(debug.StateValidationError, match="output"):
            err.throw()

    def test_checked_step_clean(self):
        pv = torch.from_numpy(SimParams(gravity=1.0).pack())
        fn = debug.checked_step(lambda p, v: step_ref.step_n(p, v, pv, 1))
        err, (p2, v2) = fn(torch.zeros(3, 8, 128), torch.ones(3, 8, 128))
        err.throw()                                # no error
        assert err.get() == "" and torch.isfinite(p2).all()

    def test_checked_step_reads_outputs_only(self):
        """A NaN masked away before the output is not reported (the check
        is on the outputs); integer outputs are not checked."""
        def masked(x):
            y = x / (x - x)
            return torch.where(torch.isfinite(y), y, 0.0), torch.ones(
                2, dtype=torch.int32)

        err, _ = debug.checked_step(masked)(torch.ones(3))
        err.throw()
        assert err.bad.shape == (1,)


class TestProfiling:
    def test_device_time_and_marginal(self):
        pv = torch.from_numpy(SimParams(gravity=1.0).pack())
        pos, vel = torch.zeros(3, 8, 128), torch.ones(3, 8, 128)

        def run_n(n):
            return step_ref.step_n(pos.clone(), vel.clone(), pv, n)

        t, out = profiling.device_time(lambda: run_n(4))
        assert t > 0 and out is not None
        assert profiling.marginal_time(run_n, 2, 12) > 0
        profiling.sync(out)                        # CPU tensors: no-op

    def test_trace_writes_files(self, tmp_path):
        pv = torch.from_numpy(SimParams().pack())
        with profiling.trace(str(tmp_path)):
            step_ref.step_n(torch.zeros(3, 8, 128), torch.ones(3, 8, 128),
                            pv, 1)
        path = tmp_path / "trace.json"
        assert path.exists() and os.path.getsize(path) > 0


class TestInterpret:
    def test_interpret_with_cpu_is_accepted(self):
        e = Engine(particle_count=300, device="cpu", interpret=True)
        assert e.method == Method.TORCH
        e.step(SimParams())

    def test_interpret_elsewhere_raises_naming_cpu(self):
        """The CUDA kernels have no interpret mode: never a silent switch
        of device."""
        with pytest.raises(ValueError, match="device='cpu'"):
            Engine(particle_count=300, device="cuda", interpret=True)


@pytest.mark.parametrize("argv", [
    ["4096", "--grid", "32", "--device", "cpu"],
    ["pmn", "4096", "--grid", "32", "--device", "cpu"]])
def test_pm_profile_modes_run(argv, capsys):
    """tools/pm_profile.py's two modes end to end at a CPU size; the
    numbers are CPU times, which the tool prints as such (the card's are
    chip_smoke.py phase 19's)."""
    times = pm_profile.main(argv)
    out = capsys.readouterr().out
    assert "on cpu" in out
    want = ("persist: whole accel_sorted" if argv[0] != "pmn"
            else "frame multi k=2")
    assert want in times and all(v > 0 for v in times.values())


def test_pm_profile_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        pm_profile.main(["4096"])
