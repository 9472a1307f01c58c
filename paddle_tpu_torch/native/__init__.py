"""Native (C++) components of the port and their build (counterpart of
paddle_tpu/native/__init__.py).

A component is native/<name>.cc with a plain C interface, compiled at
first use by one g++ process into

    paddle_tpu_torch/build/lib<name>-<hash>.so

(the hash covers the source and the flags, so an edited source is rebuilt
and a stale library never loaded; the directory is in .gitignore) and
loaded with ctypes. Nothing is built at import. Where there is no working
toolchain `load_native` warns and returns None, and the caller runs its
plain Python version (`dataplane._PyDataPlane`); `NativeDataPlane.native`
says which one runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Dict, Optional

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "build"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
LIBS = ["-lpthread"]

_lock = threading.Lock()
_cache: Dict[str, Optional[ctypes.CDLL]] = {}


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_native(name: str) -> Path:
    """Compile native/<name>.cc unless its library is built; returns the
    library's path. Raises with g++'s output if the compile fails."""
    src = _DIR / f"{name}.cc"
    lib = _target(src)
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    p = subprocess.run([cxx] + CXX_FLAGS + ["-o", str(tmp), str(src)]
                       + LIBS, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"g++ exit {p.returncode} on {src.name}:\n"
                           f"{p.stderr}")
    os.replace(tmp, lib)     # atomic: a reader never sees half a file
    return lib


def load_native(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library of native/<name>.cc, built at first use; None
    (with a warning) where it cannot be built or loaded."""
    with _lock:
        if name in _cache:
            return _cache[name]
        try:
            handle = ctypes.CDLL(str(build_native(name)))
        except (OSError, RuntimeError) as e:
            warnings.warn(f"native component {name!r} unavailable ({e}); "
                          f"falling back to its Python implementation")
            handle = None
        _cache[name] = handle
        return handle
