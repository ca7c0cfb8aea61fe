"""pm2.level_ms.headless: device milliseconds a step inside the program's
pm2.level spans (ops/pm2.py pmn_accel_raw: each refinement level's
fine_accel_fast, the masked deposit over every slot, the difference
solve and the masked gather, and its field added to the coarse one),
all levels, over the engine.step spans of the traced window."""

from benchmark import program_trace


def read(run):
    return program_trace.device_ms_per_step(run, ("pm2.level",))
