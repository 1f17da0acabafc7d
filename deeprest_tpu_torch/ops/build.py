"""Build the port's CUDA sources with ``nvcc`` at first use, load them with
``ctypes``.

Each source under ``deeprest_tpu_torch/csrc/`` (a :class:`CudaSource`)
becomes its own shared library with a plain C interface, compiled for Hopper (``sm_90a``) into
``build/kernels/`` at the root of the checkout.  The file name carries a
digest of the source and the flags, so an edited source never loads a
stale library, and a library another process already built is reused.
Nothing is built when a module is imported: the CPU tests import every
module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the toolkit's default
    location, or ``nvcc`` on ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the port's CUDA kernels build from source at first "
            "use and need the CUDA toolkit")
    return found


class CudaSource:
    """One CUDA source and its shared library.

    ``signatures`` maps each exported C function to ``(restype,
    argtypes)``; they are declared on load so ``ctypes`` never truncates a
    pointer to a 32-bit int.
    """

    def __init__(self, source: str, signatures: dict):
        self.source = os.path.join(CSRC_DIR, source)
        self.name = os.path.splitext(source)[0]
        self.signatures = dict(signatures)
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> str:
        with open(self.source, "rb") as fh:
            digest = hashlib.sha1(fh.read())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}-{digest.hexdigest()[:12]}.so")

    def start_build(self):
        """Start ``nvcc`` unless the library exists; returns ``(process,
        temporary path, final path)`` or None when there is nothing to do."""
        path = self.library_path()
        if os.path.exists(path):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, self.source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, path

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp, path = started
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source} (exit {proc.returncode}):\n"
                f"{log}")
        os.replace(tmp, path)          # atomic: a concurrent build may race

    def library(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(self.library_path())
                for fn, (restype, argtypes) in self.signatures.items():
                    getattr(lib, fn).restype = restype
                    getattr(lib, fn).argtypes = list(argtypes)
                self._lib = lib
            return self._lib


class CudaKernel:
    """One exported launch entry point of a :class:`CudaSource`, with its
    launch count.  ``launches`` is incremented by the wrapper that launches
    the kernel, once per call of the entry point and nowhere else."""

    def __init__(self, source: CudaSource, name: str):
        self.source = source
        self.name = name
        self.launches = 0

    def library(self) -> ctypes.CDLL:
        return self.source.library()


def build_all(sources) -> float:
    """Build every source in parallel (one ``nvcc`` per source, all started
    together), load them, and return the wall seconds it took."""
    t0 = time.perf_counter()
    started = [(src, src.start_build()) for src in sources]
    for src, st in started:
        src.finish_build(st)
    for src in sources:
        src.library()
    return time.perf_counter() - t0
