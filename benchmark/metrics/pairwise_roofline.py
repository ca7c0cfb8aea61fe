"""pairwise_roofline: the direct force's share of its compute-bound least
time: the flops a step needs (roofline_pairwise.pairwise_flops: 18 a
pair, count x count pairs) at 67 TFLOP/s, over the device time a step of
csrc/pairwise.cu's two kernels (the pair kernel and the slice sum)
launched inside Engine.step, the steps counted by the pair kernel's
launches."""

from benchmark import roofline_pairwise

PATTERNS = (r"pairwise_kernel", r"slice_sum_kernel")


def read(run):
    if run.trace is None:
        return None
    secs, _ = run.trace.device_time("Engine.step", PATTERNS)
    _, launches = run.trace.device_time("Engine.step", PATTERNS[:1])
    if not launches:
        return None
    flops = roofline_pairwise.pairwise_flops(run.count, run.count)
    return roofline_pairwise.roofline_pct(flops, secs / launches)
