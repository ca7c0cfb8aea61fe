"""Build the native frame packer (native/packer.cpp) with g++.

Plain C interface, loaded with ctypes (no pybind11). Compiled at first use
into ``build/torch_native/`` beside the package, named by a hash of the
source and flags, so an edited source is rebuilt and a stale library is
never loaded:

    g++ -O3 -march=native -std=c++17 -shared -fPIC -pthread packer.cpp \
        -o build/torch_native/libpsimpack_<hash>.so
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "packer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-pthread")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libpsimpack_{h.hexdigest()[:16]}.so"


def ensure_built() -> Optional[str]:
    """The library's path, building it if needed; None when there is no
    working C++ toolchain (the packer then takes its numpy version)."""
    out = library_path()
    if out.exists():
        return str(out)
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{out.stem}.{os.getpid()}.so")
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: a reader never sees a partial library
        return str(out)
    except (OSError, subprocess.SubprocessError):
        return None


if __name__ == "__main__":
    print(ensure_built() or "build failed")
