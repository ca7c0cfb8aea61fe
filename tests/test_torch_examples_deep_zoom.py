"""The port's deep zoom (particle_sim_tpu_torch/examples/deep_zoom.py)
against the JAX package's examples/deep_zoom.py --exact on the CPU."""

import re

import numpy as np

from particle_sim_tpu_torch.examples import deep_zoom
from torch_examples_common import jax_example, run_both

LINE = re.compile(r"step (\d+): core centroid \[([^\]]*)\], half-mass "
                  r"radius (\S+), repairs (\d+)$")


def parse(lines):
    """-> [(step, centroid f64[3], half-mass radius, repairs)]."""
    out = []
    for ln in lines:
        m = LINE.match(ln)
        assert m, ln
        out.append((int(m[1]), np.array(m[2].split(), float), float(m[3]),
                    int(m[4])))
    return out


def test_make_scene_is_the_jax_scripts():
    want = jax_example("deep_zoom").make_scene(5000)
    got = deep_zoom.make_scene(5000)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_deep_zoom_builds_the_flagship_composition():
    """Two tracked levels (32 / 0.6, 8 / 0.2) on the persistent order;
    --exact adds the 2-unit pmx window at 0.05 with capacity 8,192."""
    for exact in (False, True):
        argv = ["--count", "4096", "--device", "cpu"] + (
            ["--exact"] if exact else [])
        engine, _, _ = deep_zoom.build(deep_zoom.build_parser()
                                       .parse_args(argv))
        assert [(lv.window_min, lv.window_size, lv.softening)
                for lv in engine.pm2] == [(None, 32.0, 0.6),
                                          (None, 8.0, 0.2)]
        assert engine.pm_persist is True and engine.persist_resolved()
        px = engine.pmx
        assert (px is not None) == exact
        if exact:
            assert (px.window_size, px.softening, px.capacity) == (
                2.0, 0.05, 8192)


def test_deep_zoom_exact_matches_jax():
    """--exact, 2 steps at 3,000 (every member fits the capacity), a line
    a step: step 1 within one unit of the last printed place, step 2
    within 5x that (the scene's order-only chaos, chip_smoke phase 19's
    rule). ``repairs`` is not compared: the port repairs on disorder and
    makes its mirror in the class order (one repair fewer)."""
    want, got = run_both(deep_zoom, "deep_zoom",
                         ["--count", "3000", "--steps", "2",
                          "--stats-every", "1", "--exact"])
    want, got = parse(want), parse(got)
    assert [w[0] for w in want] == [g[0] for g in got] == [1, 2]
    for k, ((_, wc, wr, _), (_, gc, gr, rep)) in enumerate(zip(want, got)):
        f = 1.0 if k == 0 else 5.0
        np.testing.assert_allclose(gc, wc, rtol=0, atol=f * 0.01 + 1e-9)
        assert abs(gr - wr) <= f * 0.001 + 1e-9
        assert rep >= 0
