"""pm2.deposit_ms.headless: device milliseconds a step inside the
program's pm2.deposit spans (ops/pm2.py fine_accel_fast: each refinement
level's masked CIC deposit over every slot, pm_cuda.deposit), all
levels, over the engine.step spans of the traced window."""

from benchmark import program_trace


def read(run):
    return program_trace.device_ms_per_step(run, ("pm2.deposit",))
