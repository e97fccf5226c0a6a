"""Build and load the CUDA kernels of `repro_torch/csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
`sm_90a` into its own shared library, loaded with ctypes.  The build runs at
first use, from the checkout's sources only, into `build/kernels/` at the
repository root (listed in `.gitignore`).  A library's file name carries a
hash of its source, so an edited source is rebuilt and a stale library is
never loaded.  All sources compile at once, one `nvcc` process each.
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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("expand", "compact", "bottomup", "bits", "delta")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and /usr/local/cuda/bin): the "
            "CUDA kernels of repro_torch build only where the CUDA toolkit "
            "is installed")
    return path


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all() -> dict:
    """Compile every missing library, all sources in parallel.

    Returns {name: {"seconds", "log", "cached"}} -- the log holds nvcc's
    `-Xptxas -v` register and shared-memory summary."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {name: _lib_path(name) for name in SOURCES
            if not _lib_path(name).exists()}
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log,
                        "cached": False}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for name in SOURCES:
        report.setdefault(name, {"seconds": 0.0, "log": "", "cached": True})
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, building the sources first."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero `cudaGetLastError()` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
