"""ctypes binding for the native C++ featurization ETL
(``deeprest_tpu/data/native.py``, with the library built from the
checkout).

:func:`featurize_jsonl` matches :func:`deeprest_tpu_torch.data.featurize.
featurize_buckets` exactly, but streams the corpus twice through the C++
parser of ``native/featurizer.cpp`` instead of materializing Python span
trees.

The library is built at first use, as the CUDA sources are
(``ops/build.py``): ``g++`` from ``PATH`` with the flags of
``native/Makefile`` into ``build/native/`` at the root of the checkout,
the file name carrying a digest of the source, the compiler and the
flags; a build writes a temporary file and renames it, so processes
building at once never load a half-written library.  ``$CXX`` is not
read, and the link takes ``-z defs``: a compiler wrapper that leaves
libstdc++ out of a shared object links it without a word, and the
library then crashes at its first call into the C++ runtime; with ``-z
defs`` such a toolchain fails the build instead.  ``DEEPREST_ETL_LIB``
names a library to load instead (a sanitizer or instrumented build).  There is no Python
fallback: a failed build or ``dlopen`` raises with the compiler's output,
whatever ``require_native`` says.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from deeprest_tpu_torch.config import FeaturizeConfig
from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(REPO_ROOT, "native", "featurizer.cpp")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "native")
CXX = "g++"
# native/Makefile's CXXFLAGS and LDFLAGS, and no undefined symbol
CXX_FLAGS = ("-std=c++17", "-O3", "-Wall", "-Wextra", "-fPIC", "-shared",
             "-Wl,-z,defs")
ENV_OVERRIDE = "DEEPREST_ETL_LIB"

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def compiler() -> str:
    """``g++`` resolved on ``PATH``."""
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(
            f"C++ compiler {CXX!r} not found on PATH; the native ETL "
            f"builds {SOURCE} at first use")
    return found


def library_path(build_dir: str = BUILD_DIR) -> str:
    digest = hashlib.sha1()
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read())
    digest.update(" ".join((compiler(), *CXX_FLAGS)).encode())
    return os.path.join(build_dir,
                        f"libdeeprest_etl-{digest.hexdigest()[:12]}.so")


def build_library(build_dir: str = BUILD_DIR) -> str:
    """Build ``libdeeprest_etl`` into ``build_dir`` unless it is there;
    returns its path.  Raises with the compiler's output on failure."""
    path = library_path(build_dir)
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    proc = subprocess.run([compiler(), *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"building the native ETL from {SOURCE} failed (exit "
            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)          # atomic: a concurrent build may race
    return path


def _open_library(path: str) -> ctypes.CDLL:
    """``dlopen`` a built library and declare its two C functions."""
    lib = ctypes.CDLL(path)
    lib.drft_featurize_file.restype = ctypes.c_int
    lib.drft_featurize_file.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_ulonglong,
        ctypes.c_char_p, ctypes.c_longlong,
    ]
    lib.drft_stable_hash.restype = ctypes.c_ulonglong
    lib.drft_stable_hash.argtypes = [ctypes.c_char_p, ctypes.c_ulonglong]
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded library: ``$DEEPREST_ETL_LIB`` when set, else built from
    the checkout first if needed.  Raises when it cannot be loaded."""
    global _lib
    with _lock:
        if _lib is None:
            override = os.environ.get(ENV_OVERRIDE, "")
            if override and not os.path.exists(override):
                raise RuntimeError(
                    f"{ENV_OVERRIDE}={override!r} does not exist")
            _lib = _open_library(override or build_library())
        return _lib


def native_available() -> bool:
    """True once the library is loaded; a failed build raises."""
    return load_library() is not None


def stable_hash_native(joined: str, seed: int) -> int:
    return int(load_library().drft_stable_hash(joined.encode("utf-8"), seed))


def featurize_jsonl(
    path: str,
    config: FeaturizeConfig | None = None,
    require_native: bool = False,
) -> FeaturizedData:
    """Featurize a JSONL corpus through the native ETL.

    ``require_native`` is kept for the JAX package's signature: the port
    always takes the native path, and raises where it cannot.
    """
    del require_native
    config = config or FeaturizeConfig()
    lib = load_library()
    with tempfile.TemporaryDirectory(prefix="drft_etl_") as out_dir:
        err = ctypes.create_string_buffer(1024)
        rc = lib.drft_featurize_file(
            path.encode("utf-8"), out_dir.encode("utf-8"),
            1 if config.hash_features else 0,
            config.capacity, config.round_to, config.hash_seed,
            err, len(err),
        )
        if rc != 0:
            raise ValueError(f"native featurize failed: {err.value.decode()}")

        with open(os.path.join(out_dir, "header.json"), encoding="utf-8") as f:
            header = json.load(f)
        t, cap = header["num_buckets"], header["capacity"]
        metric_keys = header["metric_keys"]
        components = header["components"]

        def load(name, cols):
            arr = np.fromfile(os.path.join(out_dir, name), dtype="<f4")
            return arr.reshape(t, cols)

        traffic = load("traffic.bin", cap)
        resources_mat = load("resources.bin", len(metric_keys))
        invocations_mat = load("invocations.bin", len(components))

    space = CallPathSpace(config=config)
    space.frozen_capacity = cap
    if not config.hash_features:
        space.index = {
            tuple(key.split("\x1f")): i for i, key in enumerate(header["vocab"])
        }
    return FeaturizedData(
        traffic=traffic,
        resources={k: resources_mat[:, i].copy() for i, k in enumerate(metric_keys)},
        invocations={c: invocations_mat[:, i].copy() for i, c in enumerate(components)},
        space=space,
    )
