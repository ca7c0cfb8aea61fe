"""pm2.gather_ms.headless: device milliseconds a step inside the
program's pm2.gather spans (ops/pm2.py fine_accel_fast: each refinement
level's gather of its difference field, masked to its members over every
slot, pm_cuda.gather), all levels, over the engine.step spans of the
traced window."""

from benchmark import program_trace


def read(run):
    return program_trace.device_ms_per_step(run, ("pm2.gather",))
