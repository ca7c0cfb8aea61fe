"""device.idle_pct.headless: the share of the traced window in which no
operation ran on the card (one minus the union of the device intervals
over the window)."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
