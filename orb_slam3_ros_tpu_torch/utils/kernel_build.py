"""Build the package's native sources into shared libraries with a plain C
interface, loaded with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC``
compiles each CUDA library from the sources in ``csrc/`` at its first use
(``build_shared_library``); ``g++ -O3 -std=c++17 -fPIC -shared`` compiles a
host C++ library the same way (``build_host_library``: the measurement
sync, ``native/measurement_sync.cpp`` at the repo root). The output goes to
``_build/<name>-<hash>/`` under the package, keyed by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads the
library already built. There is no fallback: a missing compiler or a failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_ROOT = Path(__file__).resolve().parent.parent
CSRC = PKG_ROOT / "csrc"
BUILD_ROOT = PKG_ROOT / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels of this package are built from source at first use"
    )


def find_host_compiler() -> str:
    """Path of the host C++ compiler: $CXX, then g++ on PATH."""
    for c in (os.environ.get("CXX"), shutil.which("g++")):
        if c and shutil.which(c):
            return shutil.which(c)
    raise RuntimeError(
        "g++ not found ($CXX, PATH); the native measurement sync is built from source at first use"
    )


def _build(name: str, paths: list[Path], compiler, flags: tuple) -> tuple[ctypes.CDLL, Path]:
    """Compile ``paths`` with ``compiler()`` and ``flags`` into
    ``_build/<name>-<hash>/lib<name>.so`` unless that exists; load it."""
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.exists():
        cc = compiler()
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [cc, *flags, "-o", str(tmp), *map(str, paths)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        (out_dir / "build.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"building lib{name}.so failed (exit {proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path)), out_dir


def build_shared_library(name: str, sources: list[str]) -> tuple[ctypes.CDLL, Path]:
    """Compile ``sources`` (file names under ``csrc/``) with nvcc into
    ``lib<name>.so`` unless the same sources were built before; return the
    loaded library and the build directory (which holds ``build.log`` with
    nvcc's and ptxas's output)."""
    return _build(name, [CSRC / s for s in sources], find_nvcc, NVCC_FLAGS)


def build_host_library(name: str, sources: list[Path]) -> tuple[ctypes.CDLL, Path]:
    """Compile the C++ files ``sources`` (paths) with the host compiler and
    ``HOST_FLAGS`` into ``lib<name>.so`` unless the same sources were built
    before; return the loaded library and the build directory. The flags
    hold no ``-march=native``: the library loads on any x86-64 host."""
    return _build(name, [Path(s) for s in sources], find_host_compiler, HOST_FLAGS)
