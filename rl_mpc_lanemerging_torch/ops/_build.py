"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with ``nvcc`` into ``build/torch_kernels/lib<name>_<hash>.so`` at the
repository root (gitignored), then loaded with ``ctypes``.  The hash covers
the source and the flags, so an edit rebuilds.  Nothing is built when a
module is imported: the CPU tests import every module on machines without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

__all__ = ["NVCC_FLAGS", "build", "load", "source_path"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                          "torch_kernels")

# -fmad=false keeps the kernels' float arithmetic op for op that of their
# plain PyTorch versions (no fused multiply-add contraction).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}
_LOCK = threading.Lock()
build_seconds: dict = {}


def source_path(name: str) -> str:
    return os.path.join(_CSRC, name + ".cu")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source and
    flag set exists; return the library path."""
    src = source_path(name)
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    lib_path = os.path.join(_BUILD_DIR,
                            f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, lib_path)           # atomic: concurrent builds agree
    build_seconds[name] = time.perf_counter() - t0
    return lib_path


def load(name: str, declare) -> ctypes.CDLL:
    """Build if needed, load once per process, and let ``declare(lib)``
    set every entry point's ``argtypes``/``restype``."""
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(build(name))
            declare(lib)
            _LIBS[name] = lib
        return _LIBS[name]
