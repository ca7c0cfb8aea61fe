"""The state maker (``state.py``): each generation against the program's
own generator under the seed's rotation, bit for bit, and the hollow
sphere against a frozen copy of its code; on the card, the probe of the
scenes under the deep-zoom stack (``chip``)."""

import ast
import json
import math
import time

import numpy as np
import pytest
import torch

from benchmark import spec, state, traffic

SEEDS = (0, 7, 2 ** 33 + 5)
#: Seeds tried for the static box, the driver's large ones among them.
BOX_SEEDS = (*SEEDS, 1, 2 ** 31 + 11, 2 ** 34 + 3, 123456789)
BOX = (-64.0, 64.0)


def _config(generation, n, central_mass=0.0):
    return {"generation": generation, "count": n, "radius": 50.0,
            "central_mass": central_mass}


def _turned(seed, planes):
    """f32[3, n]: ``planes`` turned by the seed's rotation in float64."""
    rot, p = state.rotation(seed), planes.astype(np.float64)
    return (rot[:, 0, None] * p[0] + rot[:, 1, None] * p[1]
            + rot[:, 2, None] * p[2]).astype(np.float32)


def _live_and_dead(init, n):
    """The live planes as numpy, after checking the dead slots are 0."""
    cap = state.capacity(n)
    for plane in (init.pos, init.vel, init.col):
        assert plane.shape == (3, cap) and plane.dtype == torch.float32
        assert not plane[:, n:].any()
    return (init.pos[:, :n].numpy(), init.vel[:, :n].numpy(),
            init.col[:, :n].numpy())


# -- the generations ------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [4096, 1000])
def test_filled_is_the_programs_filled_sphere_turned(n, seed):
    from particle_sim_tpu_torch.core.generate import generate_filled

    init = state.initial(_config("filled", n), seed, "cpu")
    assert init.n == n and state.capacity(n) == (4096 if n == 4096
                                                 else 1024)
    pos, vel, col = _live_and_dead(init, n)
    want = _turned(seed, generate_filled(n).T)
    assert np.array_equal(pos, want)
    assert not vel.any()
    assert np.array_equal(col, (want / 50.0 + 1.0) * 0.5)
    assert init.masses is None


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [4096, 1000])
def test_the_scene_is_the_examples_scene_turned(n, seed):
    from particle_sim_tpu_torch.examples.deep_zoom import make_scene

    init = state.initial(_config("deep_zoom_scene", n), seed, "cpu")
    pos, vel, col = _live_and_dead(init, n)
    p, v = make_scene(n)
    assert np.array_equal(pos, _turned(seed, p.T))
    assert np.array_equal(vel, _turned(seed, v.T))
    assert np.array_equal(col, np.full_like(pos, np.float32(0.7)))
    assert init.masses is None


def test_the_scene_spins_its_cluster_and_core_about_their_centre():
    """Unturned: the core and the cluster about (14, 6, -4) with the
    solid-body spin, the halo at rest about the origin."""
    n = 4096
    p, v = state.deep_zoom_scene(n)
    c = np.array(state.SCENE_CENTRE, dtype=np.float32)
    core, cluster, halo = p[:n // 4], p[n // 4:n // 2], p[n // 2:]
    assert np.linalg.norm(core - c, axis=1).max() <= 0.8 + 1e-5
    assert np.linalg.norm(cluster - c, axis=1).max() <= 4.0 + 1e-5
    assert np.linalg.norm(halo, axis=1).max() <= 40.0 + 1e-4
    assert not v[n // 2:].any() and not v[:n // 2, 1].any()
    rel = p[:n // 2] - c
    assert np.array_equal(v[:n // 2, 0], -0.25 * rel[:, 2])
    assert np.array_equal(v[:n // 2, 2], 0.25 * rel[:, 0])


def frozen_hollow_initial(config, seed, device):
    """The hollow sphere's state maker, frozen: (pos, vel, col, n, masses)."""
    n, radius = int(config["count"]), float(config["radius"])
    cap = max(-(-n // 1024), 1) * 1024
    i = torch.arange(n, dtype=torch.float64, device=device)
    y = 1.0 - (i / max(n - 1, 1)) * 2.0
    r_y = torch.sqrt(torch.clamp_min(1.0 - y * y, 0.0))
    theta = (math.pi * (3.0 - math.sqrt(5.0))) * i
    sphere = torch.stack([torch.cos(theta) * r_y, y,
                          torch.sin(theta) * r_y])
    q = np.random.default_rng(seed).normal(size=4)
    w, x, yq, z = q / np.linalg.norm(q)
    rot = np.array([
        [1 - 2 * (yq * yq + z * z), 2 * (x * yq - z * w),
         2 * (x * z + yq * w)],
        [2 * (x * yq + z * w), 1 - 2 * (x * x + z * z),
         2 * (yq * z - x * w)],
        [2 * (x * z - yq * w), 2 * (yq * z + x * w),
         1 - 2 * (x * x + yq * yq)],
    ])
    rot_t = torch.as_tensor(rot, dtype=torch.float64, device=device)
    pos = torch.zeros((3, cap), dtype=torch.float32, device=device)
    pos[:, :n] = (rot_t @ (sphere * radius)).to(torch.float32)
    col = torch.zeros_like(pos)
    col[:, :n] = (pos[:, :n] / radius + 1.0) * 0.5
    masses = None
    if config.get("central_mass", 0.0) > 0.0:
        masses = torch.ones((cap,), dtype=torch.float32, device=device)
        masses[0] = float(config["central_mass"])
    return pos, torch.zeros_like(pos), col, n, masses


def _bytes(t):
    return None if t is None else t.numpy().tobytes()


@pytest.mark.parametrize("central_mass", [0.0, 1000.0])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_hollow_sphere_is_byte_for_byte_as_it_was(seed, central_mass):
    cfg = _config("hollow", 5000, central_mass)
    got = state.initial(cfg, seed, "cpu")
    want = frozen_hollow_initial(cfg, seed, "cpu")
    assert got.n == want[3]
    for a, b in zip((got.pos, got.vel, got.col, got.masses),
                    (want[0], want[1], want[2], want[4])):
        assert _bytes(a) == _bytes(b)


def test_the_filled_sphere_takes_the_central_mass():
    init = state.initial(_config("filled", 2048, 1000.0), 3, "cpu")
    assert init.masses[0] == 1000.0 and (init.masses[1:] == 1.0).all()


@pytest.mark.parametrize("generation", state.GENERATIONS)
def test_the_same_seed_gives_the_same_planes(generation):
    cfg = _config(generation, 3000)
    a, b = (state.initial(cfg, 2 ** 33 + 5, "cpu") for _ in range(2))
    for x, y in zip((a.pos, a.vel, a.col), (b.pos, b.vel, b.col)):
        assert _bytes(x) == _bytes(y)
    other = state.initial(cfg, 2 ** 33 + 6, "cpu")
    assert not torch.equal(a.pos, other.pos)


def test_an_unknown_generation_raises():
    for generation in ("spiral", "Filled", "deep_zoom"):
        with pytest.raises(ValueError, match="the state maker makes"):
            state.initial(_config(generation, 1024), 1, "cpu")


@pytest.mark.parametrize("generation", state.GENERATIONS)
def test_the_scene_lies_inside_the_static_box(generation):
    cfg = _config(generation, 20000)
    for seed in BOX_SEEDS:
        pos = state.initial(cfg, seed, "cpu").pos[:, :cfg["count"]]
        assert float(pos.min()) >= BOX[0] and float(pos.max()) < BOX[1], \
            (generation, seed)


def test_the_state_maker_imports_nothing_of_the_program():
    tree = ast.parse((spec.HERE / "state.py").read_text())
    names = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0}
    assert names <= {"__future__", "math", "typing", "numpy", "torch"}


# -- the probe on the card -------------------------------------------------------
#: The deep-zoom example's physics under ``--exact`` (its ``build``), as
#: flags added to ``deep_zoom_16m``'s command: the pairwise G 0.05, the
#: coarse softening 3, the 2-unit exact window at softening 0.05.
EXAMPLE_FLAGS = ["--pairwise-g", "0.05", "--pm-softening", "3.0",
                 "--pmx-size", "2", "--pmx-softening", "0.05"]
#: name -> (count, generation, flags added to the command)
PROBES = {
    "filled_16m": (16777216, "filled", []),
    "scene_500k": (500000, "deep_zoom_scene",
                   [*EXAMPLE_FLAGS, "--pmx-capacity", "8192"]),
    "scene_500k_65k": (500000, "deep_zoom_scene",
                       [*EXAMPLE_FLAGS, "--pmx-capacity", "65536"]),
    "scene_16m": (16777216, "deep_zoom_scene",
                  [*EXAMPLE_FLAGS, "--pmx-capacity", "65536"]),
}
PROBE_SEEDS = (2 ** 33 + 101, 2 ** 34 + 7)
PROBE_STEPS, PROBE_EVERY = 600, 10
#: The exact window counted where the engine runs none: the example's.
EXACT_SIZE = 2.0


def probe_config(name):
    n, generation, flags = PROBES[name]
    cfg = spec.config("deep_zoom_16m")
    cfg.update(count=n, generation=generation)
    cfg["cli_argv"] = [*cfg["cli_argv"], *flags, "--count", str(n)]
    return cfg


def members(eng, scene):
    """Live particles in each refinement level, in the exact window (the
    engine's, or the example's 2-unit one tracked as the engine would)
    and outside the static box; in the scene, the core's half-mass
    radius."""
    from particle_sim_tpu_torch.ops import pm, pm2, pmx

    st = eng.state
    flat = st.pos.reshape(3, -1)
    live = pm.live_mask(flat.shape[1], st.n_active, flat.device)
    levels = pm2.as_levels(eng.pm2)
    wmins = pm2._nested_wmins(flat, live, eng.pm, levels, None)
    out = {"levels": []}
    for w, lv in zip(wmins, levels):
        inside = pm2._in_window(flat, w, lv.window_size, lv.margin) & live
        out["levels"].append(int(inside.sum()))
    cfgx = eng.pmx or pmx.PMXConfig(window_size=EXACT_SIZE, softening=0.05)
    wx = pm2.clamp_nested(
        pm2.window_min(flat, None, cfgx, None, live=inside), wmins[-1],
        levels[-1], cfgx.window_size)
    out["exact_window"] = int(pmx._member_mask(flat, wx, cfgx, live).sum())
    lo = torch.tensor(eng.pm.box_min, device=flat.device)[:, None]
    off = (flat < lo) | (flat >= lo + eng.pm.box_size)
    out["outside_box"] = int((off.any(0) & live).sum())
    if not scene:
        return out
    n_core = eng.particle_count // 4
    core = flat[:, :n_core].double()
    out["core_r_half"] = float(torch.linalg.vector_norm(
        core - core.mean(1, keepdim=True), dim=0).median())
    return out


def probe(name, seed, device, steps=PROBE_STEPS, every=PROBE_EVERY):
    """Install the seed's scene as a cell does and step the engine of the
    probe's command: -> (the installed planes, reading rows)."""
    cfg = probe_config(name)
    args = traffic.cli_args(cfg, device)
    eng = traffic.build_engine(args)
    t = time.perf_counter()
    init = state.initial(cfg, seed, device)
    make_s = time.perf_counter() - t
    traffic.installer(eng, init)
    params = traffic.sim_params(args)
    st = eng.state
    installed = tuple(x.reshape(3, -1).cpu() for x in
                      (st.pos, st.vel, st.init_color))
    cuda = torch.device(device).type == "cuda"
    rows, ms = [], None
    for k in range(0, steps + 1, every):
        if cuda:
            torch.cuda.synchronize()
        row = {"probe": name, "seed": seed, "step": k, **members(eng, cfg["generation"] == "deep_zoom_scene"),
               "repairs": eng.resorts}
        if eng.pmx is not None and k:
            row["pmx_members_corrected"] = list(eng.pmx_member_count())
        if ms is not None:
            row["ms_per_step"], row["peak_bytes"] = ms
        rows.append(row)
        if k == steps:
            break
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            t0, t1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            t0.record()
        for _ in range(every):
            eng.step(params)
        if cuda:
            t1.record()
            t1.synchronize()
            ms = (t0.elapsed_time(t1) / every,
                  int(torch.cuda.max_memory_allocated()))
    rows[0]["make_s"] = make_s
    return installed, rows


@pytest.mark.chip
@pytest.mark.parametrize("name", list(PROBES))
def test_the_scene_installs_on_the_card_as_on_the_cpu(card, name):
    """Prints a JSON line a reading (run with ``-s``)."""
    for seed in PROBE_SEEDS:
        installed, rows = probe(name, seed, card)
        cpu = state.initial(probe_config(name), seed, "cpu")
        for got, want in zip(installed, (cpu.pos, cpu.vel, cpu.col)):
            assert torch.equal(got, want), (name, seed)
        for row in rows:
            print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
