"""pm.kick_momentum_ms.headless: device milliseconds a step inside the
program's pm.momentum spans (ops/pm.py momentum_clean: the live-mass
weighted mean taken off the accelerations) and pm.kick spans
(ops/pm_cuda.py kick_and_step: vel += acc*dt, then the step kernel),
over the engine.step spans of the traced window."""

from benchmark import program_trace


def read(run):
    return program_trace.device_ms_per_step(run, ("pm.momentum", "pm.kick"))
