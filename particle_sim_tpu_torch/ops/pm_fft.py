"""The isolated, exact-gradient PM solve on CUDA tensors (csrc/pm_fft.cu).

``pm._solve_isolated`` sends CUDA tensors with the exact gradient here; CPU
tensors keep the plain ``torch.fft`` path, which the tests hold to the JAX
package. The same transforms run in float32, but no pass copies its input:
a pad kernel writes the density into the live octant of a scratch grid
whose zero part was written once, four cuFFT plans in advanced layouts
(:func:`plan_specs`) read each input where the previous pass left it, one
kernel multiplies the density's spectrum by the three kernel spectra, and
one writes the kept octant of the three inverses as the interleaved
f32[G, G, G, 4] buffer the gather kernel reads. csrc/pm_fft.cu gives the
passes and their layouts.

The plans and the scratch (472 MB at G = 128, with the plans' work area:
cuFFT allocates none itself, so PyTorch's caching allocator holds and
counts all of it) are made once a (grid, device, stream), at most
SCRATCH_CACHE_SIZE sets of them: the solves queued on one stream share a
set in order, and one lock keeps two threads from queueing into one set
at once.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import NamedTuple

import torch

from ..utils import cuda_build, trace

#: Solves through csrc/pm_fft.cu in this process.
LAUNCHES = 0

#: Sets of plans and scratch kept, least recently used out (its plans
#: destroyed).
SCRATCH_CACHE_SIZE = 4
_SCRATCH: "collections.OrderedDict" = collections.OrderedDict()
_LOCK = threading.Lock()

R2C, C2C, C2R = 0, 1, 2


class FFTPass(NamedTuple):
    """One cuFFT plan in the advanced layout: ``batch`` transforms of
    ``n`` (1 or 2 dimensions); element (i0[, i1]) of transform b lies at
    ``b * idist + (i0 [* inembed[1] + i1]) * istride`` of its input, and
    likewise in its output. Strides count elements of each side's type
    (float32 or complex64)."""
    name: str
    kind: int
    n: tuple
    inembed: tuple
    istride: int
    idist: int
    onembed: tuple
    ostride: int
    odist: int
    batch: int


def plan_specs(g: int) -> tuple:
    """The four transforms of the solve at grid ``g``, in their order
    (csrc/pm_fft.cu): F12 a -> b, F3 b -> rhat, I1 p in place, I23 p ->
    rr."""
    n2, m = 2 * g, 2 * g * (g + 1)
    return (
        FFTPass("F12", R2C, (n2, n2), (n2, n2), 1, n2 * n2, (n2, g + 1), 1,
                m, g),
        FFTPass("F3", C2C, (n2,), (n2,), m, 1, (n2,), m, 1, m),
        FFTPass("I1", C2C, (n2,), (n2,), 3 * m, 1, (n2,), 3 * m, 1, 3 * m),
        FFTPass("I23", C2R, (n2, n2), (n2, g + 1), 1, m, (n2, n2), 1,
                n2 * n2, 3 * g),
    )


def scratch_shapes(g: int) -> dict:
    """name -> (shape, dtype) of the solve's scratch at grid ``g``."""
    n2 = 2 * g
    return {"a": ((g, n2, n2), torch.float32),
            "b": ((n2, n2, g + 1), torch.complex64),
            "rhat": ((n2, n2, g + 1), torch.complex64),
            "p": ((n2, 3, n2, g + 1), torch.complex64),
            "rr": ((g, 3, n2, n2), torch.float32)}


def solve_bytes(g: int) -> int:
    """Bytes the solve at grid ``g`` moves, each pass's input read once
    and its output written once (a 2D transform as one pass): the least
    its passes could move."""
    n2, m = 2 * g, 2 * g * (g + 1)
    spec = n2 * m * 8                      # one c64[2g, 2g, g+1]
    pad = 2 * g ** 3 * 4
    f12 = g * n2 * n2 * 4 + g * m * 8
    f3 = 2 * spec
    product = 4 * spec + 3 * spec
    i1 = 2 * 3 * spec
    i23 = 3 * g * m * 8 + 3 * g * n2 * n2 * 4
    crop = 3 * g ** 3 * 4 + g ** 3 * 16
    return pad + f12 + f3 + product + i1 + i23 + crop


def _make_plans(lib, g: int) -> tuple:
    """(the handles of plan_specs(g)'s plans, made on the current device,
    the bytes of work area the largest of them needs)."""
    handles, work = [], 0
    for spec in plan_specs(g):
        arr = ctypes.c_longlong * len(spec.n)
        h = ctypes.c_int(0)
        size = ctypes.c_ulonglong(0)
        err = lib.psim_fft_plan(len(spec.n), arr(*spec.n),
                                arr(*spec.inembed), spec.istride, spec.idist,
                                arr(*spec.onembed), spec.ostride, spec.odist,
                                spec.kind, spec.batch, ctypes.byref(h),
                                ctypes.byref(size))
        if err:
            for made in handles:
                lib.psim_fft_destroy(made)
            raise RuntimeError(f"cuFFT plan {spec.name} at grid {g} failed: "
                               f"cuFFT status {err - 1000}")
        handles.append(h.value)
        work = max(work, size.value)
    return tuple(handles), work


def _solver(lib, g: int, device: torch.device, stream: int) -> tuple:
    """(scratch by name, plan handles) of (g, device, stream), made on
    first use; the caller holds _LOCK and the device."""
    key = (g, str(device), stream)
    got = _SCRATCH.get(key)
    if got is not None:
        _SCRATCH.move_to_end(key)
        return got
    scratch = {name: (torch.zeros if name in ("a", "b") else torch.empty)(
        shape, dtype=dtype, device=device)
        for name, (shape, dtype) in scratch_shapes(g).items()}
    plans, work = _make_plans(lib, g)
    scratch["work"] = torch.empty(max(work, 16), dtype=torch.uint8,
                                  device=device)
    got = _SCRATCH[key] = (scratch, plans)
    while len(_SCRATCH) > SCRATCH_CACHE_SIZE:
        # cuFFT frees a plan's own device memory with cudaFree, which
        # waits for the work queued on the device; the scratch and the
        # work area go back to the caching allocator in stream order
        (_, old_dev, _), (_, plans) = _SCRATCH.popitem(last=False)
        with torch.cuda.device(torch.device(old_dev)):
            for h in plans:
                lib.psim_fft_destroy(h)
    return got


def _check(rho: torch.Tensor, ks, g: int) -> None:
    if (rho.dtype != torch.float32 or tuple(rho.shape) != (g, g, g)
            or rho.device.type != "cuda"):
        raise ValueError(f"rho must be float32[{g}, {g}, {g}] on a CUDA "
                         f"device, got {rho.dtype}{list(rho.shape)} on "
                         f"{rho.device}")
    shape = (2 * g, 2 * g, g + 1)
    if len(ks) != 3 or any(
            k.dtype != torch.complex64 or tuple(k.shape) != shape
            or k.device != rho.device or not k.is_contiguous() for k in ks):
        raise ValueError(f"the spectra must be three contiguous complex64"
                         f"{list(shape)} on {rho.device}")


def solve(rho: torch.Tensor, ks, g: int) -> torch.Tensor:
    """The isolated exact-gradient solve of ``rho`` (f32[G, G, G] on a CUDA
    device) with the doubled-grid spectra ``ks`` (three c64[2G, 2G, G+1])
    -> a new f32[G, G, G, 4] buffer: the three acceleration components
    and a zero lane a cell (pm.interleaved_view)."""
    global LAUNCHES
    _check(rho, ks, g)
    rho = rho.contiguous()
    dev = rho.device
    trace.count("pm.solve.fused")
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = cuda_build.library()
    out = torch.empty((g, g, g, 4), dtype=torch.float32, device=dev)
    with _LOCK, torch.cuda.device(dev):
        s, plans = _solver(lib, g, dev, stream)
        err = lib.psim_pm_solve(
            rho.data_ptr(), g, *(k.data_ptr() for k in ks),
            *(s[name].data_ptr()
              for name in ("a", "b", "rhat", "p", "rr", "work")),
            out.data_ptr(), *plans, 1.0 / (2 * g) ** 3, stream)
        LAUNCHES += 1
    if err >= 1000:
        raise RuntimeError(f"pm solve failed: cuFFT status {err - 1000}")
    cuda_build.check(err, "pm solve")
    return out
