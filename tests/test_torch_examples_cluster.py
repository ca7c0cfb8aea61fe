"""The port's cluster core (particle_sim_tpu_torch/examples/
cluster_core.py) against the JAX package's examples/cluster_core.py on
the CPU."""

import re

import numpy as np

from particle_sim_tpu_torch.examples import cluster_core
from torch_examples_common import jax_example, run_both

LINE = re.compile(r"step (\d+): core centroid \[([^\]]*)\], half-mass "
                  r"radius (\S+)$")


def parse(lines):
    """-> [(step, centroid f64[3], half-mass radius)] of the stats lines."""
    out = []
    for ln in lines:
        m = LINE.match(ln)
        assert m, ln
        out.append((int(m[1]), np.array(m[2].split(), float), float(m[3])))
    return out


def test_make_scene_is_the_jax_scripts():
    want = jax_example("cluster_core").make_scene(5000)
    got = cluster_core.make_scene(5000)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_cluster_core_builds_one_tracked_level():
    engine, params, _ = cluster_core.build(cluster_core.build_parser()
                                           .parse_args(["--count", "2048",
                                                        "--device", "cpu"]))
    lv = engine.pm2
    assert lv.window_min is None and lv.window_size == 24.0
    assert lv.softening == 0.6 and engine.pm.softening == 3.0
    assert engine.pairwise.gravitational_constant == 0.05
    assert engine.particle_count == 2048 and params.gravity == 0.0
    assert not engine.persist_resolved()


def test_cluster_core_matches_jax():
    """4 steps at 3,000, a line every 2: the printed centroid equal to its
    2 printed decimals within one unit of the last place, the half-mass
    radius within 0.01."""
    want, got = run_both(cluster_core, "cluster_core",
                         ["--count", "3000", "--steps", "4",
                          "--stats-every", "2"])
    want, got = parse(want), parse(got)
    assert [w[0] for w in want] == [g[0] for g in got] == [2, 4]
    for (_, wc, wr), (_, gc, gr) in zip(want, got):
        np.testing.assert_allclose(gc, wc, rtol=0, atol=0.01 + 1e-9)
        assert abs(gr - wr) <= 0.01 + 1e-9
