"""A run with the timed path broken underneath reads ``correct`` false.

Each test drives the rest of a run on the CPU at a small size (the plain
path; the harness's look for a card is skipped), with one fault planted
in the program: a step that returns its state unchanged, half of the
batch left out of the mass deposit (the other half's mass doubled), an
answer altered where it is produced (a particle's position after the
step, a pixel of the frame, a point of the stream). The cells run on one
card, so no exchange between cards can be left out.
"""

import pytest
import torch

from benchmark import harness

SEED = 2 ** 33 + 5
HEADLESS = ["pm16m.headless", "pm1m.headless"]
SERVED = ["pm16m.served"]


def _run(cell, small):
    torch.set_num_threads(2)
    return harness.run_cell(cell, SEED, 1.0, False, device="cpu",
                            overrides=small)


@pytest.mark.parametrize("cell", HEADLESS)
def test_sound_headless_run_is_correct(cell, small):
    res = _run(cell, small)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", SERVED)
def test_sound_served_run_is_correct(cell, small_server):
    res = _run(cell, small_server)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", HEADLESS)
def test_step_that_returns_its_state_unchanged(cell, small, monkeypatch):
    from particle_sim_tpu_torch.engine import Engine

    monkeypatch.setattr(Engine, "step",
                        lambda self, params: self.stats.frame_tick())
    assert not _run(cell, small)["correct"]


@pytest.mark.parametrize("cell", HEADLESS)
def test_half_of_the_batch_left_out(cell, small, monkeypatch):
    from particle_sim_tpu_torch.ops import pm

    deposit = pm.cic_deposit_ref

    def half(pos_flat, n_active, cfg, coords=None, masses=None):
        n = pos_flat.shape[1]
        keep = (torch.arange(n) < n // 2).to(torch.float32) * 2.0
        m = keep if masses is None else keep * masses
        return deposit(pos_flat, n_active, cfg, coords=coords, masses=m)

    monkeypatch.setattr(pm, "cic_deposit_ref", half)
    assert not _run(cell, small)["correct"]


@pytest.mark.parametrize("cell", HEADLESS)
def test_a_position_altered_after_the_step(cell, small, monkeypatch):
    from particle_sim_tpu_torch.engine import Engine

    step = Engine.step

    def altered(self, params):
        step(self, params)
        self.state.pos.view(3, -1)[0, 7] += 1.0

    monkeypatch.setattr(Engine, "step", altered)
    assert not _run(cell, small)["correct"]


def test_particles_swapped_late_in_a_run(small, monkeypatch):
    """A wrong permutation of 0.5 % of the particles from a run's fourth
    step on (as a faulty repair of the sorted mirror past the collapse,
    which the start stage's three steps never reach) reads false: the
    end stage reads far more than its 99th percentile."""
    from particle_sim_tpu_torch.engine import Engine

    from benchmark import traffic

    step, installer = Engine.step, traffic.installer
    since_restart, swapped = [0], []

    def counted_installer(engine, init):
        restart = installer(engine, init)

        def counted():
            since_restart[0] = 0
            restart()

        return counted

    def late_swap(self, params):
        step(self, params)
        since_restart[0] += 1
        if since_restart[0] > 3:
            # the identity-order planes, assigned back so that the sorted
            # mirror is rebuilt from them
            st = self.state
            idx = torch.arange(1, int(st.n_active), 200)  # unit masses
            for planes in (st.pos.view(3, -1), st.vel.view(3, -1)):
                planes[:, idx] = planes[:, idx.flip(0)]
            self.state = st
            swapped.append(len(idx))

    monkeypatch.setattr(traffic, "installer", counted_installer)
    monkeypatch.setattr(Engine, "step", late_swap)
    res = _run("pm16m.headless", small)
    assert swapped and not res["correct"]
    start = res["check"]["start.pos_gap"]
    assert start["value"] <= start["limit"]


def test_a_pixel_altered_in_the_frame(small_server, monkeypatch):
    from particle_sim_tpu_torch.engine import Engine

    render = Engine.render_frame_device

    def altered(self, *args, **kwargs):
        fb = render(self, *args, **kwargs).clone()
        fb[3, 5, 1] ^= 0x40
        return fb

    monkeypatch.setattr(Engine, "render_frame_device", altered)
    res = _run("pm16m.served", small_server)
    assert not res["correct"]
    assert res["check"]["frame.gap_u8"]["value"] == 64
