"""Build the port's CUDA kernels at first use and load them with ctypes.

Every source under paddle_tpu_torch/csrc/ is compiled by its own `nvcc`
process (all started together) into a shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, of every header under
csrc/ (`*.cuh`) and of the flags, so an edited source or header is rebuilt
and a stale library is never loaded. The build directory
(paddle_tpu_torch/build/) is listed in .gitignore. Nothing here runs at
import: `load` builds on its first call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared",
                           "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of each build made in this process
build_log: Dict[str, str] = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or `nvcc` on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a host with the CUDA toolkit")
    return found


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in headers():             # any source may include any header
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet,
    one nvcc process per source, all at once. Returns {name: library}.
    Raises with nvcc's output if any compile fails."""
    srcs = [s for s in sources() if names is None or s.stem in names]
    if names is not None and len(srcs) != len(set(names)):
        raise FileNotFoundError(f"no CUDA source for {names} in {CSRC_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {s.stem: _target(s) for s in srcs}
    procs = []
    for s in srcs:
        lib = out[s.stem]
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc()] + NVCC_FLAGS + ["-Xptxas", "-v", "-o", str(tmp),
                                       str(s)]
        procs.append((s.stem, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for stem, lib, tmp, p in procs:
        log, _ = p.communicate()
        build_log[stem] = log
        if p.returncode != 0:
            failed.append(f"{stem}.cu (nvcc exit {p.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)   # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return lib
