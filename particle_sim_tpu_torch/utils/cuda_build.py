"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

The sources are compiled at first use into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/libpsim_<hash>.so csrc/*.cu

The library lives in ``build/torch_kernels/`` beside the package and is
named by a hash of the sources and flags, so an edited source is rebuilt
and a stale library is never loaded. A build that fails raises; nothing
falls back to another implementation. Importing this module needs
neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# argtypes of every exported function: pointers and the stream as
# c_void_p, or ctypes would pass them as 32-bit ints and cut them
SIGNATURES = {
    "psim_step": (_P, _P, _P, _I64, _I, _P),
    "psim_compact": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "psim_deposit": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
}


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpsim_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, float]:
    """Compile the kernels unless a library of the current sources exists.
    -> (library path, seconds spent compiling; 0.0 when it was built)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.stem}.{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    # ptxas -v report (registers, shared memory, spills) beside the library
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a reader never sees a partial library
    return out, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
