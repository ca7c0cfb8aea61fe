"""pm_deposit_roofline: the PM mass deposit's share of its memory-bound
least time: the bytes a call needs (roofline.deposit_bytes: the live
particles' positions, their masses and the live mask where the path
passes them, the f32 G^3 grid written) at 3.35 TB/s, over the device
time per call of the deposit kernels launched inside Engine.step."""

from benchmark import roofline

PATTERNS = (r"pm_deposit_kernel",)


def read(run):
    if run.trace is None:
        return None
    secs, count = run.trace.device_time("Engine.step", PATTERNS)
    if not count:
        return None
    cfg = run.config
    nbytes = roofline.deposit_bytes(
        run.count, int(cfg["pm"]["grid"]),
        masses=cfg.get("central_mass", 0.0) > 0.0,
        live_mask=bool(cfg["persist"]))
    return roofline.roofline_pct(nbytes, secs / count)
