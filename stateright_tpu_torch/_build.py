"""Builds a CUDA source of ``csrc/`` into a shared library and loads it.

The port's copy of ``stateright_tpu/native/__init__.py::build_and_load``
with ``nvcc`` in place of ``g++``. Each source is a plain C interface
(no PyTorch headers), so a build takes seconds. It lands in
``stateright_tpu_torch/_build/`` at first use and is rebuilt when any
file of ``csrc/`` (the source or a header it may include) is newer. The
library is compiled to a temporary file and renamed into place, so
parallel workers never load a half-written one. A failed
build raises: the port has no path that runs without its kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

__all__ = ["BUILD_DIR", "build_and_load"]

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")


def _newest_source() -> float:
    """The latest mtime of any file under ``csrc/``."""
    root = os.path.join(_DIR, "csrc")
    return max(os.path.getmtime(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def build_and_load(name: str) -> ctypes.CDLL:
    """Compiles ``csrc/<name>.cu`` into ``_build/<name>.so`` if missing
    or stale, and loads it. The compiler's output (with ptxas' register
    and spill report) is kept in ``_build/<name>.log``."""
    src = os.path.join(_DIR, "csrc", name + ".cu")
    so = os.path.join(BUILD_DIR, name + ".so")
    if not os.path.exists(so) or os.path.getmtime(so) < _newest_source():
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            with open(os.path.join(BUILD_DIR, name + ".log"), "w") as f:
                f.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} (rc {proc.returncode}):\n"
                    f"{proc.stderr[-4000:]}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(so)
