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

import torch

PATHS = ("auto", "kernel", "reference")


def resolve_path(spec, device, *, knob: str) -> str:
    """Concretise a path spelling against the device the search runs on:
    returns "kernel" or "reference"."""
    if spec not in PATHS:
        raise ValueError(f"{knob}={spec!r}: expected one of {PATHS}")
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
