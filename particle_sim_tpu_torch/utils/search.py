"""Rank of implicit iota probes in a sorted offset vector.

Counterpart of ``rank_right_iota`` in ``particle_sim_tpu/utils/search.py``
(its ``bin_search`` arrives with the sorted-deposit rasterizer).
"""

from __future__ import annotations

import torch


def rank_right_iota(base: torch.Tensor, c_max: int) -> torch.Tensor:
    """int32[c_max] with out[kk] = searchsorted(base, kk, side='right') - 1
    for the probes kk = 0..c_max-1: one scatter-add of marks and one
    cumsum. ``base`` must be non-negative and sorted; entries >= c_max are
    dropped (they can never be <= any probe). No host read."""
    marks = torch.zeros((c_max,), dtype=torch.int32, device=base.device)
    inside = base < c_max
    marks.index_add_(0, torch.where(inside, base, 0).long(),
                     inside.to(torch.int32))
    return torch.cumsum(marks, 0, dtype=torch.int32) - 1
