"""The operations the exact window's difference pass needs, from the
member count, and its share of the compute-bound least time.

The pmx correction runs the difference instance of csrc/pairwise.cu's
pair kernel (``pairwise_kernel<true>``, then ``slice_sum_kernel``) over
the window's in-budget members: each pair takes 3 subtractions, r^2 as 3
fused multiply-adds, the second softening's r^2 as one addition, two
rsqrt (counted in no flop: they issue on the special-function units),
the cubes' difference as 3 multiplies and a fused multiply-add, the
weight as a multiply and 3 fused multiply-adds into the sum, an fma 2
flops: 22 flops a pair, as ``chip_smoke.py`` counts them. The count is
of the member pairs the window holds (the program's counter
``pmx.member_pairs``, summed over the steps), whatever tiles the kernel
sweeps past the last member.

Peak: ``roofline_pairwise``'s 67 TFLOP/s in FP32 outside the tensor
cores; ``roofline_pct`` is its share.
"""

from __future__ import annotations

from .roofline_pairwise import FP32_FLOPS_PER_S, roofline_pct  # noqa: F401

DIFF_PAIR_FLOPS = 22


def diff_flops(member_pairs: int) -> int:
    """Flops of the difference pass over ``member_pairs`` member pairs."""
    return member_pairs * DIFF_PAIR_FLOPS
