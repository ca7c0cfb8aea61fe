"""Frame packing for the streaming thin client (host code).

Counterpart of ``particle_sim_tpu/io/packer.py``, with the same two wire
formats (see native/packer.cpp for the native hot path):

  * **planar f32** (local viewer): three contiguous float32 position planes
    + RGBA8 — zero quantization, Float32Array-viewable in the browser with
    no per-element decode.
  * **compact f16** (bandwidth-constrained): interleaved 10-byte records
    (3x binary16 position + RGBA8).

Both support stride subsampling. ``pack_*`` call the port's own C++
library (native/build.py builds it at first use) when a toolchain is
there, else vectorized numpy — the results are identical (tested).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_lib = None
_lib_tried = False

RECORD_BYTES = 10


def _load_lib():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    from ..native.build import ensure_built

    path = ensure_built()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.psim_pack_f16.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.psim_gather_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def have_native() -> bool:
    return _load_lib() is not None


def _n_out(n_src: int, stride: int) -> int:
    return (n_src + stride - 1) // stride


def _check_shapes(pos_planes: np.ndarray, rgba: np.ndarray) -> None:
    """The native paths hand raw pointers to C — a mismatched rgba would
    be an out-of-bounds read there, not a Python exception."""
    if pos_planes.ndim != 2 or pos_planes.shape[0] != 3:
        raise ValueError(f"pos_planes must be [3, n], got {pos_planes.shape}")
    if rgba.ndim != 2 or rgba.shape != (pos_planes.shape[1], 4):
        raise ValueError(
            f"rgba must be [{pos_planes.shape[1]}, 4], got {rgba.shape}")


def pack_f16(pos_planes: np.ndarray, rgba: np.ndarray, stride: int = 1,
             n_threads: int = 0) -> np.ndarray:
    """pos_planes f32[3, n], rgba u8[n, 4] -> u8[n_out * 10] records."""
    pos_planes = np.ascontiguousarray(pos_planes, dtype=np.float32)
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    _check_shapes(pos_planes, rgba)
    n = pos_planes.shape[1]
    out_n = _n_out(n, stride)
    lib = _load_lib()
    if lib is not None:
        out = np.empty(out_n * RECORD_BYTES, dtype=np.uint8)
        threads = n_threads or min(os.cpu_count() or 1, 16)
        lib.psim_pack_f16(
            pos_planes.ctypes.data, rgba.ctypes.data, n, stride,
            out.ctypes.data, out_n, threads)
        return out
    # numpy fallback
    idx = np.arange(0, n, stride)
    h = pos_planes[:, idx].T.astype(np.float16)            # [n_out, 3]
    rec = np.empty((out_n, RECORD_BYTES), dtype=np.uint8)
    rec[:, :6] = h.view(np.uint8).reshape(out_n, 6)
    rec[:, 6:] = rgba[idx]
    return rec.reshape(-1)


def pack_planar_f32(pos_planes: np.ndarray, rgba: np.ndarray,
                    stride: int = 1, n_threads: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (pos f32[3, n_out] contiguous, rgba u8[n_out, 4])."""
    pos_planes = np.ascontiguousarray(pos_planes, dtype=np.float32)
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    _check_shapes(pos_planes, rgba)
    n = pos_planes.shape[1]
    out_n = _n_out(n, stride)
    lib = _load_lib()
    if lib is not None:
        pos_out = np.empty((3, out_n), dtype=np.float32)
        rgba_out = np.empty((out_n, 4), dtype=np.uint8)
        threads = n_threads or min(os.cpu_count() or 1, 16)
        lib.psim_gather_f32(
            pos_planes.ctypes.data, rgba.ctypes.data, n, stride,
            pos_out.ctypes.data, rgba_out.ctypes.data, out_n, threads)
        return pos_out, rgba_out
    idx = np.arange(0, n, stride)
    return (np.ascontiguousarray(pos_planes[:, idx]),
            np.ascontiguousarray(rgba[idx]))


def unpack_f16(buf: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of pack_f16 (for tests/clients): -> (pos f32[n,3], rgba u8[n,4])."""
    rec = np.asarray(buf, dtype=np.uint8).reshape(-1, RECORD_BYTES)
    pos = rec[:, :6].copy().view(np.float16).astype(np.float32)
    return pos.reshape(-1, 3), rec[:, 6:].copy()
