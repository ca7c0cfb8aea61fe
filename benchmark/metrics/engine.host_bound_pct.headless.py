"""engine.host_bound_pct.headless: the share of the traced window in
which the card was idle while the stepping thread was inside the
program's engine.step span (each idle gap of the device trace named by
the spans open at its middle): the idle time the host's dispatch of a
step leaves on the card."""

from benchmark import program_trace


def read(run):
    return program_trace.host_bound_pct(run)
