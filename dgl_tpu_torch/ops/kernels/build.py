"""Build and load the port's CUDA kernels.

Each ``dgl_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which
``ctypes`` loads; no PyTorch header is compiled, so a build takes seconds.
Libraries land in ``dgl_tpu_torch/_build/`` under a name that carries a
hash of the source, the headers of ``csrc/`` (``*.cuh``) and the flags,
so an edited source or header is rebuilt at its next use.  All sources are
compiled together, one ``nvcc`` each.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-I",
              CSRC_DIR)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "dgl_tpu_torch cannot be built")
    return found


def sources() -> Dict[str, str]:
    """{name: path} of every CUDA source of the port."""
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))}


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [sources()[name],
                 *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all at once.

    Returns {name: compiler log}: ``-Xptxas=-v`` makes it list each
    kernel's registers, shared memory and spills.  Raises on a failed
    build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, src in sources().items():
        lib = library_path(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, lib)
    logs = {}
    for name, (proc, tmp, lib) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{logs[name]}")
        os.replace(tmp, lib)
    return logs


def load(name: str, signatures: Optional[dict] = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use.

    ``signatures`` maps each C function to its ``argtypes``; every
    function returns an ``int`` (a ``cudaError_t``)."""
    if name not in _LIBS:
        if not os.path.exists(library_path(name)):
            build_all()
        lib = ctypes.CDLL(library_path(name))
        for fn, argtypes in (signatures or {}).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]
