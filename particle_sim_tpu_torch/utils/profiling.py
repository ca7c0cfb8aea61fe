"""Profiling and timing utilities.

Counterpart of ``particle_sim_tpu/utils/profiling.py``, with the same
functions and return values:

  * :func:`trace` records the enclosed block with ``torch.profiler`` (the
    card's kernels too, where there is one) and writes a Chrome trace
    (``trace.json``, open in chrome://tracing or Perfetto) into ``logdir``.
  * :func:`device_time` times a callable: with CUDA events on the card
    (device time from the first enqueue to the last completion), with
    ``time.perf_counter`` when its outputs are on the CPU.
  * :func:`marginal_time` cancels the dispatch overhead: it times n_small
    and n_big iterations and reports the marginal per iteration.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional, Tuple

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _cuda_device(tree) -> Optional[torch.device]:
    """The CUDA device of the first CUDA tensor in ``tree``, or None."""
    for t in _tensors(tree):
        if t.device.type == "cuda":
            return t.device
    return None


def sync(tree) -> None:
    """Wait until the work that produces ``tree`` (tensors, possibly in
    tuples, lists or dicts) is done: ``torch.cuda.synchronize`` of each
    CUDA device it holds (CPU tensors are done already)."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(logdir: str):
    """Record the enclosed block with torch.profiler; write
    ``logdir/trace.json`` (a Chrome trace) when it ends."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_time(fn: Callable, *args, reps: int = 3,
                **kw) -> Tuple[float, object]:
    """(best seconds of ``reps`` calls of fn(*args, **kw), the last
    output), after one warm-up call. On the card each call is bracketed
    by CUDA events on the current stream of its outputs' device; on the
    CPU by perf_counter."""
    out = fn(*args, **kw)
    dev = _cuda_device(out)
    sync(out)
    best = float("inf")
    for _ in range(reps):
        if dev is None:
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            best = min(best, time.perf_counter() - t0)
            continue
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = fn(*args, **kw)
        end.record(stream)
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3)
    return best, out


def marginal_time(fn_of_n: Callable[[int], object], n_small: int,
                  n_big: int, reps: int = 5) -> float:
    """Marginal seconds an iteration with the dispatch overhead cancelled.

    ``fn_of_n(n)`` runs n iterations of the workload. Returns (t_big -
    t_small) / (n_big - n_small); when jitter swamps the difference
    (t_big <= t_small), the amortized upper bound t_big / n_big instead."""
    t_small, _ = device_time(lambda: fn_of_n(n_small), reps=reps)
    t_big, _ = device_time(lambda: fn_of_n(n_big), reps=reps)
    diff = t_big - t_small
    if diff <= 0:
        return t_big / n_big
    return diff / (n_big - n_small)
