"""pm2.solve_ms.headless: device milliseconds a step inside the program's
pm2.solve spans (ops/pm2.py fine_accel_fast: each level's difference-
kernel solve, pm.solve_accel_diff, which the pm.solve span does not
hold), all levels, over the engine.step spans of the traced window."""

from benchmark import program_trace


def read(run):
    return program_trace.device_ms_per_step(run, ("pm2.solve",))
