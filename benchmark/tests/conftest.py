"""Tests of the benchmark. Most run on the CPU at small sizes; those
marked ``chip`` need a CUDA card and skip without one (the ``card``
fixture decides, when the test runs)."""

import functools
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: Small sizes for CPU runs of a cell: the plain path at G = 32. Above
#: 12,288 particles the diagnostics take the mesh potential, as at 1M.
#: The documented commands get the same sizes as their last flags.
SMALL = {"count": 16384, "pm.grid": 32,
         "cli_argv": ["--count", "16384", "--pm-grid", "32"],
         "server_argv": ["--count", "16384"]}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def small():
    return dict(SMALL)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 (README.md)")
    return torch.device("cuda")


@pytest.fixture
def small_server(monkeypatch):
    """The server's flags build PMConfig(grid=128) on the CPU at ~1 s a
    step: give them the small grid."""
    import torch

    from particle_sim_tpu_torch.app import server as srv
    from particle_sim_tpu_torch.core.params import PMConfig

    torch.set_num_threads(2)
    monkeypatch.setattr(srv, "PMConfig", functools.partial(PMConfig,
                                                            grid=32))
    return SMALL
