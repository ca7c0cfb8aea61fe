"""render.kept_read_ms.served: host milliseconds a frame of the compact
renderer's read of its kept-chunk count (the program's render.kept_read
spans, clipped to the traced window): made under the engine lock, it
waits for the queued step and the shading."""

from benchmark import program_trace


def read(run):
    return program_trace.host_ms_mean(run, "render.kept_read")
