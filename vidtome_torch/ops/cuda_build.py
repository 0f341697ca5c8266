"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each library is compiled from ``vidtome_torch/csrc`` into ``build/`` at the
root of the checkout, at first use, for ``sm_90a`` (Hopper).  The output
name carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one loads the library already built.  The sources
expose a plain C interface; nothing here includes PyTorch's headers, which
keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME`` (default ``/usr/local/cuda``) or PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of vidtome_torch are built from source at first "
                           "use")
    return found


def build_library(name: str, sources: tuple[str, ...],
                  log: list | None = None) -> ctypes.CDLL:
    """Compile ``sources`` (file names under ``csrc/``) into
    ``build/lib<name>-<hash>.so`` unless it exists, and load it.  When
    ``log`` is a list, the compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) and the build seconds are appended to it."""
    paths = [CSRC / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
        if log is not None:
            log.append((name, time.perf_counter() - t0, proc.stderr))
    return ctypes.CDLL(str(out))
