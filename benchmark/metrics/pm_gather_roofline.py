"""pm_gather_roofline: the PM acceleration gather's share of its
memory-bound least time: the bytes a call needs (roofline.gather_bytes:
the live particles' positions and the live mask where the path passes
it, the interleaved f32[G, G, G, 4] grid, f32[3] a particle written) at
3.35 TB/s, over the device time per call of the gather kernels launched
inside Engine.step."""

from benchmark import roofline

PATTERNS = (r"pm_gather_interleaved_kernel",)


def read(run):
    if run.trace is None:
        return None
    secs, count = run.trace.device_time("Engine.step", PATTERNS)
    if not count:
        return None
    cfg = run.config
    nbytes = roofline.gather_bytes(run.count, int(cfg["pm"]["grid"]),
                                   live_mask=bool(cfg["persist"]))
    return roofline.roofline_pct(nbytes, secs / count)
