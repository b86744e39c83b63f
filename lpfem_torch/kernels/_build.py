"""Build and load the package's native sources (plain C interfaces, ctypes,
no PyTorch headers).

Each ``csrc/<name>.cu`` is compiled by nvcc on first use into
``build/lpfem_torch/lib<name>-<source hash>.so`` under the checkout root
(``.gitignore`` lists ``build/``), then loaded with ``ctypes``. The hash
names the library after its source and the headers (``csrc/*.cuh``) beside
it, so an edited kernel is rebuilt and a stale library is never loaded.
Host C++ libraries (``csrc/*.cpp``, the native dof numbering and I/O of
``lpfem_torch.native``) go the same way through g++
(:func:`load_host_library`): same directory, same hash naming, and a
missing compiler or a failed build raises. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import signal
import subprocess
from pathlib import Path

__all__ = ["load_library", "build_libraries", "load_host_library",
           "BUILD_DIR", "CSRC_DIR"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "lpfem_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _kill_group(proc: subprocess.Popen) -> None:
    """Kill a compile and what it started (its own process group)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def build_libraries(names) -> dict[str, str]:
    """Compile every missing ``csrc/<name>.cu`` with one nvcc process per
    source, all started together; returns nvcc's output per name (its
    register / spill report when ``-Xptxas -v`` is in ``NVCC_FLAGS``).
    When one compile fails, the others are killed (each nvcc with the
    compilers it started) and waited on before the error is raised."""
    procs = {}
    out = {}
    try:
        for name in names:
            lib_path = _lib_path(name)
            if lib_path.exists() or name in procs:
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                process_group=0), tmp, lib_path)
        for name, (proc, tmp, lib_path) in procs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{text}")
            os.replace(tmp, lib_path)
            out[name] = text
    finally:
        for proc, tmp, _ in procs.values():
            if proc.returncode is None:     # not reaped: another one failed
                _kill_group(proc)
                proc.communicate()
            tmp.unlink(missing_ok=True)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it
    (once per process)."""
    if name in _loaded:
        return _loaded[name]
    build_libraries([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    _loaded[name] = lib
    return lib


def load_host_library(name: str, sources) -> ctypes.CDLL:
    """Compile the host C++ ``sources`` (names under ``csrc/``) with g++
    into ``build/lpfem_torch/lib<name>-<hash>.so`` if it is missing, then
    load it (once per process). Raises if g++ is missing or the build
    fails: the callers have no second implementation to switch to."""
    if name in _loaded:
        return _loaded[name]
    srcs = [CSRC_DIR / s for s in sources]
    h = hashlib.sha256()
    for src in srcs:
        h.update(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    lib_path = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not lib_path.exists():
        gxx = os.environ.get("CXX") or shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found (set CXX): lib{name} is built "
                               "from csrc/ at first use")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *GXX_FLAGS, *map(str, srcs), "-o",
                               str(tmp)], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for lib{name}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _loaded[name] = lib
    return lib
