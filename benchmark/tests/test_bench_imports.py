"""What the benchmark may import: never JAX or the JAX package (the
top-level name compared whole: the port's name begins with the JAX
package's), and in the reference nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "particle_sim_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return [p for p in spec.HERE.rglob("*.py") if "tests" not in p.parts]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_the_names_are_compared_whole(monkeypatch):
    import particle_sim_tpu_torch  # noqa: F401  (the port's name)

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "particle_sim_tpu.ops", sys)
    assert harness.forbidden_modules() == ["particle_sim_tpu"]


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "typing", "torch",
                                   "math", "numpy"}


@pytest.mark.parametrize("name", ["pm_persist_16m", "pm_autobox_1m"])
def test_the_reference_holds_nothing_of_the_program(name):
    assert harness.reference_leaks(spec.config(name)) == []


def test_the_viewer_process_loads_no_torch():
    for name in ("client.py", "wsclient.py"):
        assert not set(_imports(spec.HERE / name)) & ({"torch"} | FORBIDDEN)


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload",
         "pm1m.headless", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, timeout=120,
        cwd=spec.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
