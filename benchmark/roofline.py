"""The card's peaks and the bytes the PM kernels need, from the shapes.

A kernel's roofline share is the least time the card could take for the
work (its bytes at the peak memory rate) over the time it took. The
bytes count each input read once and each output written once, whatever
the kernel reads again, for the live particles the call serves: so the
share counts the same work whatever kernel does it.

Peaks: NVIDIA H100 SXM5 80 GB data sheet, dense rates, at the full 700 W
power limit (a run records the card's limit beside its numbers).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
#: f32[3] a particle (positions in, or accelerations out)
VEC3 = 12


def deposit_bytes(n: int, grid: int, masses: bool = False,
                  live_mask: bool = False) -> int:
    """CIC deposit: the positions (and the masses, and a bool live mask
    where the call takes them) read, the f32 G^3 grid written."""
    return n * (VEC3 + (4 if masses else 0) + (1 if live_mask else 0)) \
        + grid ** 3 * 4


def gather_bytes(n: int, grid: int, live_mask: bool = False) -> int:
    """CIC gather of the acceleration: the positions (and a live mask)
    read, the interleaved f32[G, G, G, 4] grid read, f32[3] a particle
    written."""
    return n * (2 * VEC3 + (1 if live_mask else 0)) + grid ** 3 * 16


def roofline_pct(nbytes: float, seconds: float) -> float:
    """Share (%) of the least time to move ``nbytes`` at the peak in
    ``seconds``."""
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
