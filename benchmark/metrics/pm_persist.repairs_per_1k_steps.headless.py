"""pm_persist.repairs_per_1k_steps.headless: repairs of the sorted mirror
(Engine.resorts, read at the end of each run) per 1,000 steps of the
window."""


def read(run):
    if not run.steps or "resorts" not in run.counters:
        return None
    return run.counters["resorts"] / run.steps * 1000.0
