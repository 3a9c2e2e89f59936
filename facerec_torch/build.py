"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and becomes its own shared
library, compiled by ``nvcc`` for ``sm_90a`` into ``build/`` at the repository
root and loaded with ``ctypes``. All sources compile in parallel (one
``nvcc`` process each). The host JPEG loader, ``csrc/loader.cpp``, is built
the same way by ``g++`` against libjpeg, and needs no CUDA toolkit. A
library newer than its source is reused. ``function`` binds a library's
symbol once, with its argument types. Nothing here runs at import time:
the first wrapper that launches a kernel (or the first native batcher)
builds it.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
LOADER = "loader"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name == LOADER else f"{name}.cu")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return not lib.exists() or lib.stat().st_mtime < _source(name).stat().st_mtime


def build(names: tuple[str, ...] = SOURCES, force: bool = False) -> float:
    """Compile the named kernels (all at once, one ``nvcc`` each); returns
    the wall seconds. The ptxas report of each goes to ``build/<name>.log``."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{n}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def build_loader(force: bool = False) -> float:
    """Compile the host JPEG loader with ``g++`` (``-ljpeg -lpthread``) into
    ``build/libloader.so``; returns the wall seconds. Raises RuntimeError
    with the compiler's output when it fails (no g++ or no libjpeg)."""
    if not (force or _stale(LOADER)):
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{LOADER}.{os.getpid()}.tmp.so"
    cmd = ["g++", *GXX_FLAGS, str(_source(LOADER)), "-ljpeg", "-lpthread", "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ failed for {LOADER}.cpp: {e}") from e
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed for {LOADER}.cpp (exit {out.returncode}):\n{out.stderr}")
    os.replace(tmp, _lib_path(LOADER))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name`` (or ``LOADER``), built first
    if needed."""
    if name not in _loaded:
        if name == LOADER:
            build_loader()
        else:
            build((name,))
        _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    return _loaded[name]


@functools.cache
def function(lib: str | Path | ctypes.CDLL, symbol: str, argtypes: tuple, restype=ctypes.c_int):
    """``symbol`` of a library with its argument and return types set, bound
    once: ``lib`` is the name of one of this module's libraries (built
    first if needed), the path of another shared library, or a loaded one."""
    if isinstance(lib, str):
        lib = library(lib)
    elif isinstance(lib, Path):
        lib = ctypes.CDLL(str(lib))
    fn = lib[symbol]  # a pointer of its own: another binding of the symbol keeps its types
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
