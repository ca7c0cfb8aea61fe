"""pm2.windows_ms.headless: device milliseconds a step inside the
program's pm2.windows spans (ops/pm2.py pmn_accel_raw: the nested window
origins, a mass-weighted centroid reduction and a membership mask a
level over every slot), over the engine.step spans of the traced
window."""

from benchmark import program_trace


def read(run):
    return program_trace.device_ms_per_step(run, ("pm2.windows",))
