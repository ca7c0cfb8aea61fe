"""diagnostics.ms.headless: host milliseconds per
Engine.diagnostics(potential=True) call in the window; the call ends with
its own reads of the results, so this is its whole cost to the run."""

import statistics


def read(run):
    d = run.spans.durations.get("Engine.diagnostics")
    return statistics.fmean(d) * 1e3 if d else None
