"""Build a CUDA source of ``ops/csrc/`` into a shared library.

Each kernel source has a plain C interface and is compiled by ``nvcc`` for
Hopper (``sm_90a``) at first use, into the package's ``_build/`` directory
(listed in ``.gitignore``); the wrappers load it with ``ctypes``.  Nothing
here includes PyTorch's headers, so a build takes seconds.
"""

from __future__ import annotations

import glob
import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def build(source: str, lib_name: str, flags=()) -> str:
    """Compile ``source`` (with extra nvcc ``flags``) into
    ``BUILD_DIR/lib_name``; returns its path.  Rebuilds when the source or
    a header of ``csrc/`` is newer than the library.  Concurrent builds of
    different sources are safe (each writes its own temporary file)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, lib_name)
    newest = max(os.path.getmtime(f) for f in
                 [source, *glob.glob(os.path.join(CSRC, "*.cuh"))])
    if os.path.exists(out) and os.path.getmtime(out) >= newest:
        return out
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(nvcc):
        nvcc = "nvcc"
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out
