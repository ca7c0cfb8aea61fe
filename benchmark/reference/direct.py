"""The plain reference of the direct-sum configuration (``direct_65k``).

Plain PyTorch, written from the physics the configuration states and
from nothing of the program: it imports neither the program nor JAX. It
runs on the device it is given, after the program's state has been
freed. From the particle-mesh reference (``pm.py``) it takes the
precisions, the kick and the attractor step (``PMReference.steps``) and
the frame, and computes the force as a direct sum:

    a_i = G sum_j m_j (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^(3/2)

over every live source, the self term included (it is 0: the softening
keeps its denominator positive). The receivers are taken in blocks of at
most ``BLOCK_PAIRS`` pairs, so that 65,536^2 pairs in float64 need ~6 GB
of temporaries a block on a card that holds nothing else. No matrix
product is used, so TF32 does not arise.

Departures from ``pm.py``:

  * the force: the direct sum above in place of the mesh, so no grid, no
    box and no momentum clean (the program takes no mean out either);
  * ``steps`` returns the softening length as the unit of ``pos_gap``,
    where the mesh returns its cell;
  * no diagnostics: no cell of this configuration takes them.

``precision`` is "float64" (the reference), "float32" (the witness of
``check.py``'s "vs_f32": the same arithmetic in the precision the
configuration states) or "bfloat16", the control: float32 arithmetic,
every state plane and acceleration rounded to bfloat16.
"""

from __future__ import annotations

import torch

from .pm import PMReference, PRECISIONS

#: Receiver-source pairs of one block of the sum (a float64 [3, B, n]
#: difference is 1.5 GiB at this size).
BLOCK_PAIRS = 1 << 26


class DirectReference(PMReference):
    def __init__(self, config: dict, device, precision: str = "float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.g_const = float(config["g_const"])
        self.softening = float(config["softening"])
        self.display_u8 = config.get("display_colour") == "u8"
        self.device = torch.device(device)
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32

    def accel(self, x: torch.Tensor, m: torch.Tensor):
        """(acceleration [3, n], softening) of the live particles x with
        source masses m, by the direct sum in receiver blocks."""
        n = x.shape[1]
        gm = (self.g_const * m)[None, None, :]
        eps_sq = self.softening * self.softening
        a = torch.empty_like(x)
        rows = max(1, BLOCK_PAIRS // max(n, 1))
        for i0 in range(0, n, rows):
            d = x[:, None, :] - x[:, i0:i0 + rows, None]     # [3, B, n]
            w = gm * ((d * d).sum(0, keepdim=True) + eps_sq) ** -1.5
            a[:, i0:i0 + rows] = (d * w).sum(2)
        return self._q(a), self.softening

    def diagnostics(self, pos, vel, masses) -> dict:
        raise ValueError("the direct-sum reference takes no diagnostics")


def make(config: dict, device, precision: str = "float64") -> DirectReference:
    return DirectReference(config, device, precision)
