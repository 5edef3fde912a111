"""Build a CUDA source of this package into a shared library, at first use.

Each kernel lives in ``kernels/<name>/csrc/*.cu`` with a plain C
interface.  ``load_library`` compiles it with ``nvcc`` for ``sm_90a``
into ``build/repro_torch/`` at the root of the checkout (``.gitignore``
lists ``build/``), names the library after a hash of the source and the
flags — so an edited source is rebuilt and an unchanged one is loaded
as it is — and opens it with ``ctypes``.  Importing this module needs no
``nvcc``: the build runs inside the first call that launches a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Tuple

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

_LOCK = threading.Lock()
_SOURCE_LOCKS: Dict[str, threading.Lock] = {}
_LOADED: Dict[str, Tuple[ctypes.CDLL, str]] = {}


def find_nvcc() -> str:
    """The nvcc to build with: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source at first use")


def load_library(source: Path) -> Tuple[ctypes.CDLL, str]:
    """(library, compiler log) for ``source``, building it if its hashed
    library is not in ``BUILD_DIR`` yet.  Thread-safe; one build per
    process and source, and two sources build at once from two threads."""
    source = Path(source)
    key = str(source)
    with _LOCK:
        lock = _SOURCE_LOCKS.setdefault(key, threading.Lock())
    with lock:
        if key in _LOADED:
            return _LOADED[key]
        digest = hashlib.sha256(
            source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"{source.stem}-{digest}.so"
        log = f"{lib_path.name}: cached"
        if not lib_path.exists():
            # build into a temporary name, then rename: a concurrent
            # process never opens a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed on {source.name} ({proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib_path)
            log = proc.stdout + proc.stderr
        lib = ctypes.CDLL(str(lib_path))
        _LOADED[key] = (lib, log)
        return lib, log
