"""The operations the direct force needs, from the shapes, and its share
of the compute-bound least time.

The direct sum (csrc/pairwise.cu) is bound by FP32 arithmetic, not by
memory: each pair takes 3 subtractions, r^2 as 3 fused multiply-adds
(eps^2 as the first addend), one rsqrt (counted in no flop: it issues on
the special-function units), w as 3 multiplies and 3 fused multiply-adds
into the sum, an fma 2 flops: 18 flops a pair, as ``chip_smoke.py``
counts them. The count is of the pairs the call covers, whatever the
kernel does again.

Peak: 67 TFLOP/s in FP32 outside the tensor cores (NVIDIA H100 SXM5 80
GB data sheet, at the full 700 W power limit). A tensor-core form of the
force (the matrix-product form of csrc/pairwise_mxu.cu) does other work
on other units: moving the cell onto it needs this count, and its peak,
revisited by a change to the benchmark.
"""

from __future__ import annotations

FP32_FLOPS_PER_S = 67e12
PAIR_FLOPS = 18


def pairwise_flops(n_i: int, n_j: int) -> int:
    """Flops of the direct force of ``n_i`` receivers from ``n_j``
    sources."""
    return n_i * n_j * PAIR_FLOPS


def roofline_pct(flops: float, seconds: float) -> float:
    """Share (%) of the least time to do ``flops`` at the FP32 peak in
    ``seconds``."""
    return 100.0 * flops / FP32_FLOPS_PER_S / seconds
