"""One run of one cell, from its name to its result line.

:func:`run_cell` loads the cell's configuration, traffic mix and check by
name (``spec.py``), drives the program with the mix (``traffic.py``),
judges what the program produced against the plain reference
(``check.py``), reads the cell's metrics with their readers
(``metrics/<name>.py``) and returns the result: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check``, each compared number beside its limit.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Optional

import torch

from . import check, spec
from . import trace as tracing
from . import traffic as traffic_mod

#: Top-level module names that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "particle_sim_tpu")
PROGRAM = "particle_sim_tpu_torch"


class Run:
    """The state of one run, shared by the driver, the check and the
    metric readers."""

    def __init__(self, cell_name: str, seed: int, seconds: float,
                 trace_on: bool, device: str, t_process: float,
                 overrides: Optional[dict] = None):
        self.spec = spec.load_spec()
        entry = spec.workload(self.spec, cell_name)
        self.cell_name = cell_name
        self.chips = int(entry["chips"])
        self.config = spec.config(entry["config"])
        for key, value in (overrides or {}).items():
            _override(self.config, key, value)
        self.traffic = spec.traffic(entry["traffic"])
        self.cell = spec.cell(cell_name)
        self.seed, self.seconds = int(seed), float(seconds)
        self.trace_on, self.device = bool(trace_on), device
        self.t_process = t_process
        self.spans = tracing.Spans()
        #: span durations of a traced run's untraced pass (traffic.py)
        self.untraced: dict = {}
        self.trace: Optional[tracing.TraceView] = None
        self.counters: dict = {}
        self.setup_s = self.window_s = 0.0
        self.steps = self.attempted = self.failed = 0
        self.frames_in_window = 0
        self.generator_late_ms: Optional[float] = None
        self.memory_peak = 0
        self.outputs: Optional[check.Outputs] = None
        self.init = None
        self.params: dict = {}

    @property
    def count(self) -> int:
        return int(self.config["count"])


def _override(config: dict, key: str, value) -> None:
    """Set a dotted key ("pm.grid") of a configuration, or add flags to
    one of its commands ("cli_argv", "server_argv"; tests only)."""
    if key.endswith("_argv"):
        if key in config:
            config[key] = [*config[key], *value]
        return
    *path, last = key.split(".")
    d = config
    for p in path:
        d = d[p]
    d[last] = value


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def reference_leaks(config: dict) -> list:
    """Names in the reference module that come from the program."""
    mod = check.reference_module(config)
    leaks = []
    for name, value in vars(mod).items():
        origin = getattr(value, "__module__", None) or getattr(
            value, "__name__", "")
        if isinstance(origin, str) and origin.split(".")[0] == PROGRAM:
            leaks.append(name)
    return leaks


def device_info(run: Run) -> dict:
    info = {"platform": "gpu" if run.device == "cuda" else run.device,
            "kind": (torch.cuda.get_device_name(0) if run.device == "cuda"
                     else "cpu"),
            "count": run.chips, "memory_peak_bytes": run.memory_peak}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s()
        info["window_s"] = run.trace.window_s
    return info


def read_metrics(run: Run) -> dict:
    out = {}
    for entry in spec.metrics_for(run.spec, run.cell_name, run.trace_on):
        value = spec.metric_reader(entry["name"]).read(run)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def run_cell(cell_name: str, seed: int, seconds: float, trace_on: bool, *,
             device: str = "cuda", t_process: Optional[float] = None,
             overrides: Optional[dict] = None) -> dict:
    """Run the cell once; -> the result (the last line a run prints)."""
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    run = Run(cell_name, seed, seconds, trace_on, device,
              time.perf_counter() if t_process is None else t_process,
              overrides)
    traffic_mod.DRIVERS[run.traffic["kind"]](run)
    # the program's state is freed before the reference runs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    nums, _ = check.judge(run.config, run.cell["check"], run.init,
                          run.params, run.outputs, device)
    correct, rows = check.verdict(nums, run.cell["check"]["limits"])
    result = {"correct": bool(correct and run.failed == 0),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": read_metrics(run), "device": device_info(run)}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    if run.generator_late_ms is not None:
        result["generator_late_ms_p95"] = run.generator_late_ms
    result["check"] = rows
    return result
