"""Build a CUDA source of this package into a shared library at first use.

``nvcc`` compiles the ``.cu`` file with a plain C interface into
``<repo>/build/kernels/`` (listed in ``.gitignore``), named by a hash of the
source and flags so an edited source rebuilds; ``ctypes`` loads it. Nothing
here runs at import time, and nothing falls back: a missing compiler or a
failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)),
                         "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is not None:
            nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "multimodn_tpu_torch need the CUDA toolkit")
    return nvcc


def library_path(source_name: str) -> str:
    """Where ``csrc/<source_name>`` builds to: named by a hash of the
    source and the flags. The ptxas report (registers, shared memory,
    spills) lies beside it as ``<library>.log``."""
    with open(os.path.join(CSRC_DIR, source_name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source_name)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build_library(source_name: str) -> ctypes.CDLL:
    """Compile ``csrc/<source_name>`` (once per content) and load it."""
    src = os.path.join(CSRC_DIR, source_name)
    lib_path = library_path(source_name)
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            with open(lib_path + ".log", "w") as f:
                f.write(proc.stdout + proc.stderr)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(lib_path)
