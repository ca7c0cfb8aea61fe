"""pm_persist.verdict_ms.headless: device milliseconds a step inside the
program's persist.verdict spans (ops/pm_persist.py needs_repair, queued
every CHECK_EVERY-th step: the sort keys of the state as it stands, with
refinement levels their window origins and membership masks, and the
disorder count), over the engine.step spans of the traced window."""

from benchmark import program_trace


def read(run):
    return program_trace.device_ms_per_step(run, ("persist.verdict",))
