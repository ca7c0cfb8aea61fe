"""pmx_diff_roofline: the exact window's difference pass's share of its
compute-bound least time: the flops of the member pairs the window held
over the window's steps (the program's counter pmx.member_pairs, at
roofline_pmx's 22 flops a pair) at 67 TFLOP/s, over the device time of
csrc/pairwise.cu's two kernels (the pair kernel and the slice sum)
launched inside Engine.step in the window. In a cell whose configuration
runs no direct sum only the difference instance runs there."""

from benchmark import program_trace, roofline_pmx

PATTERNS = (r"pairwise_kernel", r"slice_sum_kernel")


def read(run):
    if run.trace is None:
        return None
    pairs = (program_trace.counters(run) or {}).get("pmx.member_pairs")
    secs, launches = run.trace.device_time("Engine.step", PATTERNS)
    if not pairs or not launches or secs <= 0.0:
        return None
    return roofline_pmx.roofline_pct(roofline_pmx.diff_flops(pairs), secs)
