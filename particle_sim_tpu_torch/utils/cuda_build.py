"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

The sources are compiled at first use into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds): one
nvcc per source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <source>.o csrc/<source>.cu     # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/torch_kernels/libpsim_<hash>.so *.o -lcufft

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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
#: The libraries the kernels call: cuFFT (csrc/pm_fft.cu).
LINK_FLAGS = ("-lcufft",)

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_float)
# argtypes of every exported function: pointers and the stream as
# c_void_p, or ctypes would pass them as 32-bit ints and cut them
SIGNATURES = {
    "psim_step": (_P, _P, _P, _I64, _I, _P),
    # pos, vel, params, n, acc, mean, live, n_active, g, cell (NULL where
    # unused), stream
    "psim_kick_step": (_P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _P),
    # acc, n, live, n_active, masses, partials, counter, max blocks, out,
    # stream
    "psim_momentum_sums": (_P, _I64, _P, _P, _P, _P, _P, _I, _P, _P),
    # grid4, rho, cells, partials, counter, max blocks, out, stream
    "psim_momentum_sums_grid": (_P, _P, _I64, _P, _P, _I, _P, _P),
    # pos, n, live, masses, sums in, parent, origin, mask, sums out, count,
    # partials, counter, max blocks, static origin x y z, half, clamp lo,
    # clamp hi, shrink, extent, stream
    "psim_window_pass": (_P, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _F, _F, _F, _F, _F, _F, _F, _F, _P),
    "psim_compact": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "psim_deposit": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # xi, xj, gv, eps_sq, n_i, n_j (NULL: ni, nj), out, partial, ni, nj,
    # slices, diff, stream
    "psim_pairwise": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "psim_sorted_deposit": (_P, _P, _P, _P, _I, _I, _P),
    "psim_pm_deposit": (_P, _I, _P, _P, _P, _P, _P, _I, _F, _I, _P, _P),
    "psim_pm_deposit_sorted": (_P, _I, _P, _P, _P, _P, _P, _I, _F, _I, _P,
                               _P),
    "psim_pm_gather": (_P, _I, _I, _P, _I, _P, _P, _P, _P, _I, _F, _I,
                       _P, _P),
    # grids, pos, vel, n, n_active, live, box_min, cell, g, hi, periodic,
    # params, mean, scale, scale cell (NULL: a static box), stream
    "psim_pm_gather_kick": (_P, _P, _P, _I, _P, _P, _P, _P, _I, _F, _I, _P,
                            _P, _P, _P, _P),
    # xi, order, xj, gv, eps_sq, box, out, ni, nj, stream
    "psim_pairwise_mxu": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # int32[6] out: registers, shared bytes, blocks an SM, threads, local
    # bytes, receivers a block
    "psim_pairwise_mxu_occupancy": (_P,),
    # points, box, keys out, n, bits, stream
    "psim_hilbert_keys": (_P, _P, _P, _I, _I, _P),
    # points, n, stride, count, box out, stream
    "psim_inlier_box": (_P, _I, _I, _I, _P, _P),
    # key in, 3 payloads in, key out, 3 payloads out (NULL where unused),
    # n, [run,] payload count, key flip (0 or INT_MIN), stream
    "psim_block_sort": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "psim_merge_round": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _P),
    # key in, n, key flip, workspace, its bytes, stream
    "psim_radix_hist": (_P, _I, _I, _P, _I64, _P),
    # key + 3 payloads in, out, scratch (NULL where unused), n, digit,
    # payload count, key flip, workspace, its bytes, passes-taken tally,
    # stream
    "psim_radix_pass": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                        _I, _I, _I, _P, _I64, _P, _P),
    # rank, n, inembed, istride, idist, onembed, ostride, odist, type,
    # batch, plan out, work bytes out
    "psim_fft_plan": (_I, _P, _P, _I64, _I64, _P, _I64, _I64, _I, _I64, _P,
                      _P),
    "psim_fft_destroy": (_I,),
    # rho, g, 3 spectra, scratch a, b, rhat, p, rr, work, out, 4 plans,
    # scale, stream
    "psim_pm_solve": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                      _I, _I, _F, _P),
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


def library_path(build_dir=None) -> Path:
    """The library of the current sources in ``build_dir`` (default
    BUILD_DIR)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libpsim_{h.hexdigest()[:16]}.so"


def build(build_dir=None) -> Tuple[Path, float]:
    """Compile the kernels into ``build_dir`` (default BUILD_DIR) unless a
    library of the current sources is there. -> (library path, seconds
    spent compiling; 0.0 when it was built)."""
    out = library_path(build_dir)
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    stem = f".{out.stem}.{os.getpid()}"
    tmp = out.with_name(stem + ".so")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.parent / f"{stem}.{src.stem}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{text}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *[str(o) for o in objs], *LINK_FLAGS, "-Xlinker",
             f"-rpath={Path(nvcc).resolve().parent.parent / 'lib64'}"],
            capture_output=True, text=True)
        if link.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    # ptxas -v report (registers, shared memory, spills) beside the library
    out.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, out)  # atomic: a reader never sees a partial library
    return out, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    path, _ = build()
    return load(path)


def load(path) -> ctypes.CDLL:
    """A built kernel library (:func:`build`) loaded, with the argument
    types of every exported function set."""
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
