"""The control: the reference computed a precision below what the
configuration states (bfloat16 for the float32 state and diagnostics,
float8 for the frame's bfloat16 colour words), in the program's place,
must read ``correct`` false under every cell's limits. On the CPU at a
small size; on the card at the cell's own size (marked ``chip``)."""

import gc
import time

import pytest
import torch

from benchmark import check, harness, traffic

CELLS = ["pm16m.headless", "pm1m.headless", "pm16m.served"]


def _readings(cell, device, seconds, overrides=None):
    run = harness.Run(cell, 2 ** 34 + 9, seconds, False, device,
                      time.perf_counter(), overrides)
    traffic.DRIVERS[run.traffic["kind"]](run)
    gc.collect()
    nums, cnums = check.judge(run.config, run.cell["check"], run.init,
                              run.params, run.outputs, device,
                              with_control=True)
    return run.cell["check"]["limits"], nums, cnums


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_cpu(cell, small_server):
    torch.set_num_threads(2)
    limits, nums, cnums = _readings(cell, "cpu", 1.0, small_server)
    assert check.verdict(nums, limits)[0], nums
    assert not check.verdict(cnums, limits)[0], cnums


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card(cell, card):
    limits, nums, cnums = _readings(cell, "cuda", 2.0)
    assert check.verdict(nums, limits)[0], nums
    assert not check.verdict(cnums, limits)[0], cnums
