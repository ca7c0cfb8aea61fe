"""Shared drivers of the example tests (tests/test_torch_examples_*.py):
the JAX package's ``examples/<name>.py`` as its docstring's CPU line runs
it (a subprocess with JAX_PLATFORMS=cpu and the compile cache off), and
the port's ``particle_sim_tpu_torch.examples.<name>.main`` in this process
on the CPU, on the same arguments, at the same time."""

import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_example(name: str):
    """The JAX package's examples/<name>.py as a module (its scene
    builders; importing it runs nothing)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_both(module, name: str, args: list, *, jax_args=None,
             timeout: float = 240.0):
    """-> (JAX stdout lines, port stdout lines) of examples/<name>.py and
    ``module.main(args + ["--device", "cpu"])``, run side by side;
    ``jax_args`` (default ``args``): the JAX script's, where an output
    directory must differ."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PSIM_NO_COMPILE_CACHE="1")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", f"{name}.py"),
         *(args if jax_args is None else jax_args)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = module.main([*args, "--device", "cpu"])
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert rc == 0
    assert proc.returncode == 0, err[-4000:]
    return out.splitlines(), buf.getvalue().splitlines()
