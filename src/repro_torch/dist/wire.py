"""The wire bytes of the collectives a step runs, with the ring algorithm's
factors (the JAX package's `repro/launch/roofline.py` applies the same ones
to the collectives it parses out of XLA's text):

  all-gather / reduce-scatter / all-to-all : (n-1)/n x full size
  all-reduce                               : 2 (n-1)/n x size
  collective-permute                       : 1 x size

On a `StackedMesh` a collective is a tensor operation on one device and
nothing travels; the stacked collectives (`dist.topology.StackedTopology`'s
`row_gather`, `col_all_to_all` and `psum_all`, the MoE's `_all_to_all` and
FSDP gather) `mark` their input with what they would put on the wire of a
real mesh, and the dry run's roofline reads it inside `counting()`: the
forward's collective, and in the backward pass its transpose (an
all-gather's gradient is a reduce-scatter, an all-to-all's an
all-to-all), as JAX's differentiated program holds both.  Outside
`counting()` `mark` returns its input and records nothing.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("wire_count",
                                                         default=None)


def ring_bytes(kind: str, size: float, n: int) -> float:
    """The bytes one member puts on the wire for a collective over a
    group of n whose full logical size is `size` bytes (the gathered
    result of an all-gather, the operand of a reduce-scatter)."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}")
    if kind == "all-reduce":
        return 2 * (n - 1) / n * size
    if kind == "collective-permute":
        return float(size)
    return (n - 1) / n * size


@dataclasses.dataclass
class WireCount:
    """Wire bytes and calls by collective kind, summed over the devices of
    the stacked meshes the recorded collectives ran on."""
    bytes: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    counts: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})

    @property
    def total(self) -> float:
        return sum(self.bytes.values())


@contextlib.contextmanager
def counting():
    """Count the stacked collectives run inside: yields a `WireCount`."""
    wc = WireCount()
    token = _ACTIVE.set(wc)
    try:
        yield wc
    finally:
        _ACTIVE.reset(token)


# the collective the gradient of each kind runs
_TRANSPOSE = {"all-gather": "reduce-scatter", "reduce-scatter": "all-gather",
              "all-to-all": "all-to-all", "all-reduce": "all-reduce",
              "collective-permute": "collective-permute"}


def _record(wc, kind: str, size: float, n: int) -> None:
    wc.bytes[kind] += ring_bytes(kind, size, n)
    wc.counts[kind] += 1


class _Mark(torch.autograd.Function):
    """The identity, recording its collective's transpose when the
    gradient passes."""

    @staticmethod
    def forward(ctx, t, wc, kind, size, n):
        ctx.wc, ctx.kind, ctx.size, ctx.n = wc, kind, size, n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        _record(ctx.wc, _TRANSPOSE[ctx.kind], ctx.size, ctx.n)
        return g, None, None, None, None


def mark(t: torch.Tensor, kind: str, size: float, n: int) -> torch.Tensor:
    """t, about to enter one stacked collective over groups of n devices:
    `size` is the collective's full logical size summed over every device
    it runs on (each device's `ring_bytes` argument, times the devices).
    Inside `counting()` it records the collective, and its transpose when
    a gradient flows back through t."""
    wc = _ACTIVE.get()
    if wc is None:
        return t
    _record(wc, kind, size, n)
    if t.requires_grad:
        return _Mark.apply(t, wc, kind, size, n)
    return t
