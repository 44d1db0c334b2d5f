"""Build and load the hand-written CUDA kernels.

Each source under ``kernels/csrc/`` has a plain C interface and is
compiled by ``nvcc`` into its own shared library, loaded with
:mod:`ctypes` (no PyTorch headers, so a build takes seconds). Builds
happen at first use, into ``build/repro_torch/`` at the repository root
(git-ignored), under a name that carries the hash of the source and the
flags: an edited source rebuilds, an unchanged one loads the library on
disk. Nothing here runs at import time.
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

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "build", "build_all",
           "load"]

_HERE = os.path.dirname(os.path.abspath(__file__))

SOURCES = {
    "cluster_spgemm": os.path.join(_HERE, "csrc", "cluster_spgemm.cu"),
    "cluster_spgemm_padded": os.path.join(_HERE, "csrc",
                                          "cluster_spgemm_padded.cu"),
    "cluster_spgemm_revisit": os.path.join(_HERE, "csrc",
                                           "cluster_spgemm_revisit.cu"),
    "cluster_spmm": os.path.join(_HERE, "csrc", "cluster_spmm.cu"),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    """``build/repro_torch/`` at the repository root."""
    return os.path.normpath(os.path.join(_HERE, "..", "..", "..", "build",
                                         "repro_torch"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _lib_path(name: str) -> str:
    with open(SOURCES[name], "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start one nvcc process into a temp file; returns (proc, tmp, lib)
    or None when the library is already built."""
    lib = _lib_path(name)
    if os.path.exists(lib):
        return None
    nvcc = _nvcc()
    os.makedirs(build_dir(), exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(lib) + ".",
                               suffix=".tmp", dir=build_dir())
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[name]]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, started) -> str:
    """Wait for one nvcc process, publish its library atomically and
    return the compiler's output (``-Xptxas -v`` register/spill report)."""
    if started is None:
        return ""
    proc, tmp, lib = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return log


def build(name: str) -> str:
    """Build one kernel library if it is not on disk; returns nvcc's
    output (empty when nothing was built)."""
    with _LOCK:
        return _finish(name, _start(name))


def build_all() -> tuple[float, dict[str, str]]:
    """Build every kernel library, one nvcc per source, all started
    together. Returns (wall seconds, {name: nvcc output})."""
    t0 = time.perf_counter()
    with _LOCK:
        started = {name: _start(name) for name in SOURCES}
        logs = {name: _finish(name, s) for name, s in started.items()}
    return time.perf_counter() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build(name)
        with _LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                lib = ctypes.CDLL(_lib_path(name))
                _LOADED[name] = lib
    return lib
