"""pmx.diff_ms.headless: device milliseconds a step inside the program's
pmx.diff spans (ops/pmx.py exact_accel: the exact window's difference
pass, csrc/pairwise.cu's pair kernel and its slice sum over the compact
member buffer), over the engine.step spans of the traced window."""

from benchmark import program_trace


def read(run):
    return program_trace.device_ms_per_step(run, ("pmx.diff",))
