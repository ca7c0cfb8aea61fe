"""server.frame_host_ms.served: host milliseconds a frame of the server's
work after the engine lock (the program's server.frame_host spans,
clipped to the traced window): the frame's fetch to the host, its header
and its payload bytes."""

from benchmark import program_trace


def read(run):
    return program_trace.host_ms_mean(run, "server.frame_host")
