"""Roofline terms of a traced step, the port of `repro/launch/roofline.py`.

Three terms, per device (per card):
  compute    = FLOPs / PEAK_FLOPS
  memory     = HBM bytes / HBM_BW
  collective = wire bytes / ICI_BW

The rates are one NVIDIA H100 SXM 80GB's at its full 700 W (NVIDIA's data
sheet; the JAX package's are a TPU v5e's): 989 TFLOP/s dense bf16, 3.35
TB/s of HBM, and NVLink 4's 450 GB/s each way as the link; 80 GB of HBM
a card.  A roofline of the dry run is a count of shapes times these
rates: no card ran it.

Where the JAX package parses the compiled, partitioned HLO text, the port
counts the step it traces on the meta device (`count_step`):

  flops  the formulas of `torch.utils.flop_counter` (`FlopCounterMode`'s)
         for every op of the whole step (forward, backward, optimizer):
         2 x the multiply-adds of every matmul, bmm, einsum and
         convolution -- the JAX analyzer's convention for dots.  The port traces loops as they run, so a
         loop counts every trip, as the JAX analyzer's trip-weighted
         while bodies do.
  bytes  the operand and result bytes of every dispatched op (views
         excluded; an expanded operand counts its distinct elements), by
         a `TorchDispatchMode`.  This is the port's own count of an
         unfused program: XLA counts the top-level instructions of its
         fused one, so the two differ by the fusion.
  wire   the collectives the step runs on the stacked mesh (the MoE's
         all_to_all, the 2D SpMM's and the BFS's row_gather /
         col_all_to_all / psum_all), `dist.wire` with JAX's ring factors.
         The port runs the dense layers whole on every device of the
         stacked mesh, so GSPMD's inferred tensor-parallel collectives
         have no counterpart.

The stacked step is the whole mesh's work, so every per-device figure is
its total / n_chips (JAX's SPMD module is per device).  The JAX module's
HLO-text readers (`parse_collective_bytes`, `analyze_hlo`,
`cost_analysis_dict`, `_shape_bytes`, `_group_size`) have no counterpart:
the port has no HLO.
"""
from __future__ import annotations

import dataclasses
import math
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.dist import wire
from repro_torch.dist.wire import COLLECTIVES, ring_bytes  # noqa: F401

PEAK_FLOPS = 989e12       # bf16 dense per card (H100 SXM, 700 W)
HBM_BW = 3.35e12          # bytes/s (H100 SXM HBM3)
ICI_BW = 450e9            # bytes/s each way (H100 NVLink 4)
HBM_BYTES = 80e9          # bytes of HBM per card (H100 SXM 80GB)


def _distinct_bytes(t: torch.Tensor) -> int:
    """A tensor's bytes counting each element of its storage once: a
    broadcast (stride 0) dim counts one element."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _tensors(x) -> list:
    """The tensors in a nest of tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


class _Count(TorchDispatchMode):
    """FLOPs and operand + result bytes of every op dispatched inside, and
    the peak bytes of the tensors the ops allocated that are alive at
    once."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if func.is_view:
            return out
        outs = _tensors(out)
        self.bytes += sum(_distinct_bytes(t)
                          for t in _tensors((args, kwargs)) + outs)
        fresh = [o for o, r in zip(outs, func._schema.returns)
                 if r.alias_info is None]
        for o in fresh:
            n = _distinct_bytes(o)
            self.live += n
            weakref.finalize(o, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


@dataclasses.dataclass
class StepCount:
    """What tracing one step counted, summed over the stacked mesh."""
    flops: float
    bytes: float
    wire: wire.WireCount
    peak_bytes: float        # allocated intermediates alive at once
    out: object              # the step's outputs (meta tensors)
    seconds: float           # the trace's wall time


def count_step(fn, *args) -> StepCount:
    """Run fn(*args) once (meta tensors: shapes only) and count it."""
    t0 = time.perf_counter()
    with _Count() as bc, wire.counting() as wc:
        out = fn(*args)
    return StepCount(flops=float(bc.flops), bytes=float(bc.bytes),
                     wire=wc, peak_bytes=float(bc.peak), out=out,
                     seconds=time.perf_counter() - t0)


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    collective_detail: dict
    model_flops: float | None = None
    useful_ratio: float | None = None

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(count: StepCount, *, model_flops: float | None = None,
            n_chips: int = 1) -> Roofline:
    """The per-device roofline of a counted stacked step over n_chips
    devices.  model_flops is GLOBAL (the whole step's useful FLOPs)."""
    flops = count.flops / n_chips
    hbm = count.bytes / n_chips
    det = {k: v / n_chips for k, v in count.wire.bytes.items()}
    det["_counts"] = dict(count.wire.counts)
    wire_b = count.wire.total / n_chips
    c, m, w = flops / PEAK_FLOPS, hbm / HBM_BW, wire_b / ICI_BW
    dom = max((("compute", c), ("memory", m), ("collective", w)),
              key=lambda t: t[1])[0]
    ratio = None
    if model_flops:
        ratio = model_flops / max(flops * n_chips, 1.0)
    return Roofline(flops=flops, hbm_bytes=hbm, wire_bytes=wire_b,
                    compute_s=c, memory_s=m, collective_s=w, dominant=dom,
                    collective_detail=det, model_flops=model_flops,
                    useful_ratio=ratio)
