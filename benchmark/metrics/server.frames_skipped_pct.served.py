"""server.frames_skipped_pct.served: the share of the frames the server
built in the traced window that no client writer sent (latest wins: a
writer still sending skips to the newest frame): 100 x (built - sent) /
built, from the program's counters server.frames_built and
server.frames_sent."""

from benchmark import program_trace


def read(run):
    counts = program_trace.counters(run)
    built = (counts or {}).get("server.frames_built", 0)
    if not built:
        return None
    return 100.0 * (built - counts.get("server.frames_sent", 0)) / built
