"""Prefix-sum row compaction (DESIGN.md sec. 10), the port of
`repro/kernels/fold.py:compact_rows`.

`compact_rows` front-packs each row's masked entries, in order, and pads
with per-channel fills: the argsort replacement `core.frontier.
compact_blocks` takes on the main path (`dist.exchange.expand_exchange`,
every level).  For CUDA tensors it computes the count prefix with
torch.cumsum and launches `csrc/compact.cu` once per channel; for CPU
tensors it runs `plain_compact_rows`, a stable argsort of ~mask.  Both are
bit-identical: the output is fully determined by the mask.

The module itself is the engines' fold-kernel bundle (`ops`): call sites
write `ops.compact_rows(...)`, and `ops=None` means the plain formulas.
Only `compact_rows` is ported so far; the bitmap and delta codec kernels
(`pack_bits`, `unpack_bits`, `delta_gaps`, `delta_positions`) come with
those codecs (ROADMAP A6).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.select import launches_kernel


def plain_compact_rows(mask, arrays, fills):
    """Stable-argsort compaction in plain torch, on any device."""
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    keep = torch.gather(mask, 1, order)
    packed = tuple(
        torch.where(keep, torch.gather(a, 1, order),
                    torch.tensor(int(f), dtype=torch.int32,
                                 device=mask.device))
        for a, f in zip(arrays, fills))
    return packed, mask.sum(dim=1, dtype=torch.int32)


def _launcher():
    fn = build.library("compact").compact_rows_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def compact_rows(mask, arrays, fills):
    """Front-pack each row's valid entries, preserving order.

    mask: (N, S) bool validity; arrays: aligned (N, S) int32 channels;
    fills: per-channel pad values.  Returns (tuple of packed (N, S) int32
    arrays, (N,) int32 counts).  CUDA tensors launch the kernel once per
    channel (counted in `compact_rows.launches`); CPU tensors run the plain
    version."""
    arrays = tuple(arrays)
    fills = tuple(int(f) for f in fills)
    if len(fills) != len(arrays):
        raise ValueError(f"compact_rows: {len(arrays)} channels but "
                         f"{len(fills)} fills")
    if not launches_kernel(mask, "compact_rows"):
        return plain_compact_rows(mask, arrays, fills)
    dev = mask.device
    if mask.dim() != 2 or mask.dtype != torch.bool \
            or not mask.is_contiguous():
        raise ValueError(f"compact_rows: mask must be a contiguous (N, S) "
                         f"bool tensor, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    for a in arrays:
        if a.shape != mask.shape or a.dtype != torch.int32 \
                or a.device != dev or not a.is_contiguous():
            raise ValueError(
                f"compact_rows: channels must be contiguous int32 "
                f"{tuple(mask.shape)} on {dev}, got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
    N, S = mask.shape
    if N > 65535:
        raise ValueError(f"compact_rows: {N} rows exceed the grid's 65535")
    if S == 0:
        empty = tuple(torch.empty((N, 0), dtype=torch.int32, device=dev)
                      for _ in arrays)
        return empty, torch.zeros(N, dtype=torch.int32, device=dev)
    inc = torch.cumsum(mask, dim=1, dtype=torch.int32)
    fn = _launcher()
    packed = []
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for a, f in zip(arrays, fills):
            out = torch.empty((N, S), dtype=torch.int32, device=dev)
            rc = fn(mask.data_ptr(), inc.data_ptr(), a.data_ptr(),
                    out.data_ptr(), N, S, f, stream)
            build.check(rc, "compact_rows")
            compact_rows.launches += 1
            packed.append(out)
    return tuple(packed), inc[:, -1].contiguous()


compact_rows.launches = 0
