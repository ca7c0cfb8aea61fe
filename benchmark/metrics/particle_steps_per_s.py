"""particle_steps_per_s: every particle-step completed in the window over
the window's seconds (host clock; the window ends with a device
synchronisation, so every counted step has run)."""


def read(run):
    if run.window_s <= 0 or not run.steps:
        return None
    return run.steps * run.count / run.window_s
