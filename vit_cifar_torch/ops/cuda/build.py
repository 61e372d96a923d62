"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface (the
headers ``csrc/*.cuh`` it includes are shared).  It is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/kernels/`` at the root of the checkout,
under a name keyed by a hash of the source, the headers and the flags, so a
stale library is never loaded.  :func:`build_libraries` starts one ``nvcc``
per source, all at once.  Nothing is built at import time: the CPU-only test
machine has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``, the toolkit's install location)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME "
        f"({home}); the CUDA kernels need the CUDA toolkit to build")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: keyed by a
    hash of the source, the shared headers and the compiler flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_libraries(names) -> None:
    """Compile every missing library of ``names``, one ``nvcc`` each, all
    started together.  The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside each library as
    ``<library>.log``."""
    jobs = []
    for name in dict.fromkeys(names):
        lib = library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in jobs:
        report, _ = proc.communicate()
        lib.with_suffix(".log").write_text(report)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{report}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    build_libraries([name])
    return ctypes.CDLL(str(library_path(name)))
