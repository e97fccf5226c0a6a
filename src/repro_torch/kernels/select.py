"""Kernel-path selection (the `BFSConfig(expand=...)` / `BFSConfig(fold=...)`
rules of DESIGN.md sec. 9 + 10, decided by the tensors' device).

  "auto"       the hand-written CUDA kernel on a CUDA device, the plain
               torch formulas on the CPU;
  "kernel"     the CUDA kernel; raises on a CPU device;
  "reference"  the plain torch formulas on any device.

No environment variable changes the path: what runs is what the config and
the device say.
"""
from __future__ import annotations

import functools

import torch

PATHS = ("auto", "kernel", "reference")


def check_path(spec, *, knob: str) -> None:
    """Raise on a path spelling that is not one of PATHS."""
    if spec not in PATHS:
        raise ValueError(f"{knob}={spec!r}: expected one of {PATHS}")


def resolve_path(spec, device, *, knob: str) -> str:
    """Concretise a path spelling against the device the search runs on:
    returns "kernel" or "reference"."""
    check_path(spec, knob=knob)
    on_cuda = torch.device(device).type == "cuda"
    if spec == "auto":
        return "kernel" if on_cuda else "reference"
    if spec == "kernel" and not on_cuda:
        raise ValueError(
            f"{knob}='kernel' needs a CUDA device, got {torch.device(device)}"
            f"; use {knob}='auto' or 'reference' on the CPU")
    return spec


def launches_kernel(t: torch.Tensor, what: str) -> bool:
    """A kernel wrapper's dispatch: True for a CUDA tensor (launch the
    kernel), False for a CPU tensor (the plain version), raise otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for device "
                     f"{t.device}")


def chunk_hook(kernel, plain, path: str, **fixed):
    """A chunk hook for a path spelling, fixed when the hook is made:
    "reference" is the plain version, "auto" the kernel wrapper (which
    launches on CUDA tensors and runs the plain version on CPU tensors),
    "kernel" the kernel wrapper behind one test that refuses non-CUDA
    tensors.  `fixed` are keyword arguments bound into the hook (tile)."""
    check_path(path, knob="path")
    if path == "reference":
        return functools.partial(plain, **fixed)
    if path == "auto":
        return functools.partial(kernel, **fixed)

    def on_cuda(start, n_lanes, cumul, *args, **kw):
        if not cumul.is_cuda:
            raise ValueError(
                f"path='kernel' needs a CUDA device, got {cumul.device}; "
                "use path='auto' or 'reference' on the CPU")
        return kernel(start, n_lanes, cumul, *args, **fixed, **kw)

    return functools.update_wrapper(on_cuda, kernel)
