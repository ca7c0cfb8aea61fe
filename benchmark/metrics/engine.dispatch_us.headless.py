"""engine.dispatch_us.headless: host microseconds per Engine.step call
(no device synchronisation): what the host pays to queue a step. Read in
the traced run from its pass of one run of the mix with the profiler
off, just before the traced window (the profiler inflates the host's
dispatch)."""

import statistics


def read(run):
    d = run.untraced.get("Engine.step")
    return statistics.fmean(d) * 1e6 if d else None
