"""Build and load the port's CUDA kernels (`repro_torch/csrc/*.cu`).

Each source compiles with `nvcc` for Hopper (`sm_90a`) into its own
shared library with a plain C interface, loaded with `ctypes`. The
build happens at first use, never at import: every source is compiled
at once, one `nvcc` process each, into `build/repro_torch/` at the root
of the checkout. A library's file name carries a hash of its source, the
shared header and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` turns a non-zero code into an exception.
There is no fallback: without `nvcc` or a card the build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
_BOUND: dict[tuple[str, str], object] = {}
_BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return path


def sources() -> list[Path]:
    """Every kernel source of the port, in name order."""
    return sorted(CSRC.glob("*.cu"))


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    for part in (src.read_bytes(), (CSRC / "common.cuh").read_bytes(),
                 " ".join(NVCC_FLAGS).encode()):
        h.update(part)
    return BUILD_DIR / f"lib{src.stem}.{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every stale source in parallel; load every library.
    Returns the seconds spent compiling (0.0 when all were fresh)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        _BUILD_LOG[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    seconds = time.perf_counter() - t0 if procs else 0.0
    for src in sources():
        if src.stem not in _LIBS:
            _LIBS[src.stem] = ctypes.CDLL(str(_target(src)))
    return seconds


def build_log() -> dict[str, str]:
    """nvcc's output (register and shared-memory use) per source built
    by this process."""
    return dict(_BUILD_LOG)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building on first use."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def bind(name: str, symbol: str, n_ptrs: int, n_ints: int,
         n_floats: int = 0):
    """The C entry `symbol` of `csrc/<name>.cu`, typed as `n_ptrs` device
    pointers, then `n_ints` 64-bit integers, then `n_floats` floats,
    then the stream."""
    fn = _BOUND.get((name, symbol))
    if fn is None:
        fn = getattr(lib(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                       + [ctypes.c_longlong] * n_ints
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[(name, symbol)] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
