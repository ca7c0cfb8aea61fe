"""BENCHMARK.json against the contract, and every part found by name."""

import json
import math
import re
import shlex

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_spec()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_command_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_a_full_check_fits_with_24_cells(bench):
    runs = 2 + 14 * 24
    assert (runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


def test_names_units_and_lines(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    assert len({n for _, n in names}) == len(names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"]) and w["chips"] in (1, 4)


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s"}


def test_every_part_is_found_by_name(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert spec.config(c["name"])["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for w in bench["workloads"]:
        assert spec.traffic(w["traffic"])["kind"] in ("headless", "served")
        check = spec.cell(w["name"])["check"]
        assert set(check) == {"steps", "stats", "limits"}
        assert w["config"] in {c["name"] for c in bench["configs"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
        assert set(m.get("workloads", cells)) <= cells


def test_each_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in spec.metrics_for(bench, w["name"], False)}
        layer = spec.metrics_for(bench, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_layers_are_named_in_perf_md(bench):
    perf = (spec.ROOT / "PERF.md").read_text()
    for m in bench["per_layer"]:
        assert _line(m["layer"])
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_roofline_names(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_run_py_names_no_part(bench):
    src = (spec.HERE / "run.py").read_text()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert e["name"] not in src, e["name"]
    for w in bench["workloads"]:
        assert w["traffic"] not in src


def test_files_under_paths_are_named_from_name_characters(bench):
    for path in spec.HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_configs_state_what_they_cut(bench):
    for c in bench["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]
        assert math.isfinite(cfg["count"]) and cfg["count"] > 0


def test_every_generation_is_one_the_state_maker_makes(bench):
    """And a sphere is the one its command's ``--generation`` names
    (hollow by default)."""
    from benchmark import state, traffic

    for c in bench["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["generation"] in state.GENERATIONS, c["name"]
        if cfg["generation"] in state.SPHERES:
            args = traffic.cli_args(cfg, "cpu")
            assert args.generation == cfg["generation"], c["name"]


def _documented_argv(source):
    """The flags of the README command a configuration's ``source``
    names, without ``--device``."""
    words = shlex.split(source.split(":", 1)[1])
    argv = words[words.index("python") + 3:]
    k = argv.index("--device")
    return argv[:k] + argv[k + 2:]


def _engine_fields(engine):
    pm = engine.pm
    return {"pm": {"grid": pm.grid, "box_min": list(pm.box_min),
                   "box_size": pm.box_size, "softening": pm.softening,
                   "boundary": pm.boundary, "gradient": pm.gradient,
                   "auto_box": pm.auto_box},
            "g_const": engine.pairwise.gravitational_constant,
            "pairwise_softening": engine.pairwise.softening,
            "persist": engine.pm_persist is True}


def _config_fields(cfg):
    return {"pm": cfg["pm"], "g_const": cfg["g_const"],
            "pairwise_softening": cfg["pm"]["softening"],
            "persist": cfg["persist"]}


@pytest.mark.parametrize("name", ["pm_persist_16m", "pm_autobox_1m"])
def test_the_engine_is_the_documented_command(bench, name):
    """The engine the harness builds from ``cli_argv`` (the CLI's own
    parser) is the one the configuration's physics states, and
    ``cli_argv`` is the README command its ``source`` names."""
    from benchmark import traffic

    cfg = spec.config(name)
    assert cfg["cli_argv"] == _documented_argv(cfg["source"])
    args = traffic.cli_args(cfg, "cpu")
    assert args.count == cfg["count"]
    assert args.central_mass == cfg["central_mass"]
    small = {**cfg, "cli_argv": [*cfg["cli_argv"], "--count", "2048"]}
    engine = traffic.build_engine(traffic.cli_args(small, "cpu"))
    assert _engine_fields(engine) == _config_fields(cfg)
    for w in bench["workloads"]:
        tr = spec.traffic(w["traffic"])
        if w["config"] == name and tr["kind"] == "headless":
            assert (tr["steps_per_run"], tr["stats_every"],
                    tr["diagnostics"]) == (args.steps, args.stats_every,
                                           args.diagnostics)


def test_the_served_engine_is_the_configuration(bench):
    """The server the served cells start (``server_argv`` through
    ``make_server``) runs the engine the configuration states."""
    from particle_sim_tpu_torch.app import server as srv

    from benchmark import traffic

    for w in bench["workloads"]:
        tr = spec.traffic(w["traffic"])
        if tr["kind"] != "served":
            continue
        cfg = spec.config(w["config"])
        argv = traffic.server_argv(cfg, tr, "cpu")
        assert srv.build_parser().parse_args(argv).count == cfg["count"]
        server = srv.make_server([*argv, "--count", "2048"])
        assert _engine_fields(server.engine) == _config_fields(cfg)
