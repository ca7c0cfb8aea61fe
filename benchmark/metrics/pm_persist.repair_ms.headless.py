"""pm_persist.repair_ms.headless: device milliseconds a repair of the
sorted mirror: the program's persist.repair spans (ops/pm_persist.py
repair_state: the keys, the radix sort and the gathers of every payload)
that began in the traced window."""

from benchmark import program_trace


def read(run):
    return program_trace.device_ms_mean(run, "persist.repair")
