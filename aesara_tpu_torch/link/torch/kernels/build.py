"""Building the hand-written kernels.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (a build takes
seconds; a PyTorch C++ extension would take minutes).  Libraries go into
the git-ignored ``_build/`` directory beside this file, named by a hash of
their source, the headers under ``csrc/`` and the flags, so a checkout
builds them on first use.  With no ``nvcc`` a build raises: a CUDA run
never falls back to a plain version.

Triton kernels are Python source that Triton reads from a file:
:func:`triton_module` writes a source into ``_build/triton/`` and imports
it, so no module of the package imports ``triton`` when it is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
from typing import Dict, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_locks: Dict[str, threading.Lock] = {}
_lock = threading.Lock()


def build_dir(*parts: str) -> str:
    """A directory under the kernels' build directory, created on demand."""
    path = os.path.join(_HERE, "_build", *parts)
    os.makedirs(path, exist_ok=True)
    return path


def triton_module(src: str, stem: str):
    """The module whose source is ``src``, written once to the build
    directory under a name made of ``stem`` and a hash of the source."""
    digest = hashlib.sha256(src.encode()).hexdigest()[:20]
    path = os.path.join(build_dir("triton"), f"{stem}_{digest}.py")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(src)
        os.replace(tmp, path)
    spec = importlib.util.spec_from_file_location(f"aesara_tpu_torch_{stem}_{digest}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, then ``/usr/local/cuda``, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def load_cuda_library(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it.  The library is named
    by a hash of the source, every header under ``csrc/`` (which a source
    may include), the flags and ``defines`` (``NAME=VALUE`` macros, each
    passed as ``-D``; a build variant, loaded beside the default one).
    Libraries of different names may be built at the same time from several
    threads."""
    key = "|".join((name, *defines))
    with _lock:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        if key in _libs:
            return _libs[key]
        src = os.path.join(CSRC, f"{name}.cu")
        flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
        digest = hashlib.sha256(" ".join(flags).encode())
        for path in [src, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
            with open(path, "rb") as f:
                digest.update(f.read())
        out = os.path.join(build_dir(), f"lib{name}-{digest.hexdigest()[:16]}.so")
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *flags, "-o", tmp, src]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}\n{res.stderr}")
            os.replace(tmp, out)
        _libs[key] = ctypes.CDLL(out)
        return _libs[key]
