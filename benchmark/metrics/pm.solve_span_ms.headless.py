"""pm.solve_span_ms.headless: device milliseconds a step inside the
program's pm.solve spans (ops/pm.py solve_accel: the pads, transforms,
spectral multiplies and copies of the whole solve), over the engine.step
spans of the traced window."""

from benchmark import program_trace


def read(run):
    return program_trace.device_ms_per_step(run, ("pm.solve",))
