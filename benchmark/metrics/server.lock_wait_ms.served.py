"""server.lock_wait_ms.served: host milliseconds the server's sim thread
waits for the engine lock before a step (the program's server.lock_wait
spans, clipped to the traced window), a step."""

from benchmark import program_trace


def read(run):
    return program_trace.host_ms_mean(run, "server.lock_wait")
