"""pmx.members_ms.headless: device milliseconds a step inside the
program's pmx.members spans (ops/pmx.py exact_accel: the exact window's
origin, its member mask, the flag sort members first, the compaction into
the pair buffer, and after the pass the scatter of the corrections back),
over the engine.step spans of the traced window."""

from benchmark import program_trace


def read(run):
    return program_trace.device_ms_per_step(run, ("pmx.members",))
