"""The bytes the PM kernels need, against chip_smoke's bounds, and the
roofline readers on a synthetic trace."""

import pytest

from benchmark import roofline, spec
from benchmark import trace as tr


def test_deposit_bytes_match_chip_smoke():
    # chip_smoke.py phase 13: 20.4 MB at 1M, 209.7 MB at 16M (G = 128)
    assert roofline.deposit_bytes(1_000_000, 128) == 20_388_608
    assert roofline.deposit_bytes(16_777_216, 128) == 209_715_200
    assert roofline.deposit_bytes(1_000_000, 128, masses=True,
                                  live_mask=True) == 20_388_608 + 5_000_000


def test_gather_bytes():
    assert roofline.gather_bytes(1_000_000, 128) == 24_000_000 + 33_554_432
    assert roofline.gather_bytes(16, 2, live_mask=True) == 16 * 25 + 128


def test_roofline_share():
    # the least time of 3.35 GB is 1 ms at the peak
    assert roofline.roofline_pct(3.35e9, 2e-3) == pytest.approx(50.0)


class _Run:
    def __init__(self, config, view):
        self.config, self.trace = config, view

    @property
    def count(self):
        return int(self.config["count"])


def test_deposit_roofline_reader():
    cfg = spec.config("pm_autobox_1m")
    secs = roofline.deposit_bytes(cfg["count"], 128) / roofline.HBM_BYTES_PER_S
    ops = [("void pm_deposit_kernel<false>", 0.0, 4 * secs, "a"),
           ("void pm_deposit_kernel<false>", 1.0, 1.0 + 4 * secs, "b"),
           ("pm_gather_interleaved_kernel", 2.0, 2.5, "c")]
    spans = [tr.HostEvent("Engine.step", 0.0, 3.0, 1)]
    view = tr.build_view(ops, {k: [(0.5, 1)] for k in "abc"}, spans, [],
                         0.0, 3.0)
    got = spec.metric_reader("pm_deposit_roofline").read(_Run(cfg, view))
    assert got == pytest.approx(25.0)
    assert spec.metric_reader("pm_deposit_roofline").read(
        _Run(cfg, tr.build_view([], {}, spans, [], 0.0, 3.0))) is None
