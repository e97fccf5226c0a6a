"""The fold-path kernels (DESIGN.md sec. 10), the port of
`repro/kernels/fold.py`: prefix-sum row compaction and the bitmap codec's
bit packing.

`compact_rows` front-packs each row's masked entries, in order, and pads
with per-channel fills: the argsort replacement `core.frontier.
compact_blocks` takes on the main path (`dist.exchange.expand_exchange`,
every level).  For CUDA tensors it computes the count prefix with one flat
torch.cumsum (`row_prefix`) and launches `csrc/compact.cu` once per
channel; for CPU tensors it runs `plain_compact_rows`, a stable argsort of
~mask.  Both are bit-identical: the output is fully determined by the
mask.

`pack_bits` / `unpack_bits` turn (N, S) bool rows into (N, ceil(S/32))
int32 words holding the JAX uint32 bit pattern and back: `BitmapFold`'s
encode and decode on every fold.  CUDA tensors launch `csrc/bits.cu`; CPU
tensors run `plain_pack_bits` / `plain_unpack_bits`
(`core.frontier.pack_bitmap` / `unpack_bitmap`).

`delta_gaps` / `delta_positions` are the delta codec's encode and decode
stages: sorted per-row offsets -> 16-bit first-order gaps, and gaps ->
int32 per-row inclusive cumsum.  The 16-bit arrays are int16 tensors
holding the JAX uint16 bit pattern (`core.frontier.u16_bits`).  CUDA
tensors launch `csrc/delta.cu`; CPU tensors run `plain_delta_gaps` /
`plain_delta_positions`.

The module itself is the engines' fold-kernel bundle (`ops`): call sites
write `ops.compact_rows(...)`, `ops.pack_bits(...)`, `ops.delta_gaps(...)`,
and `ops=None` means the plain formulas.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import frontier as F
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


def row_prefix(mask):
    """(N, S) bool -> (N, S) int32 inclusive count prefix of each row.

    One scan over the flattened mask, then each row's base subtracted:
    torch's scan along the last dim of a 2D tensor works a row per thread
    block, so a few rows of 2^24 slots leave most of the card idle, while
    the flat scan spreads over all of it."""
    N, S = mask.shape
    inc = torch.cumsum(mask.reshape(-1), 0, dtype=torch.int32).view(N, S)
    if N > 1:
        base = inc[:-1, -1].clone()
        inc[1:] -= base[:, None]
    return inc


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
    inc = row_prefix(mask)
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


def plain_pack_bits(mask):
    """(N, S) bool -> (N, ceil(S/32)) int32 words in plain torch."""
    return F.pack_bitmap(mask)


def plain_unpack_bits(words, S: int):
    """(N, W) int32 words -> (N, S) bool in plain torch."""
    return F.unpack_bitmap(words, S)


def _bits_launcher(name):
    fn = getattr(build.library("bits"), f"{name}_launch")
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = ([p, p, i64, i64, p] if name == "pack_bits"
                       else [p, p, i64, i64, i64, p])
        fn.restype = ctypes.c_int
    return fn


def pack_bits(mask):
    """(N, S) bool -> (N, ceil(S/32)) int32 little-endian words, pad bits 0.
    The input is checked on every device; then CUDA tensors launch the
    kernel (counted in `pack_bits.launches`) and CPU tensors run the plain
    version."""
    if mask.dim() != 2 or mask.dtype != torch.bool \
            or not mask.is_contiguous():
        raise ValueError(f"pack_bits: mask must be a contiguous (N, S) bool "
                         f"tensor, got {mask.dtype} {tuple(mask.shape)}")
    if not launches_kernel(mask, "pack_bits"):
        return plain_pack_bits(mask)
    N, S = mask.shape
    if N > 65535:
        raise ValueError(f"pack_bits: {N} rows exceed the grid's 65535")
    words = torch.empty((N, (S + 31) // 32), dtype=torch.int32,
                        device=mask.device)
    if words.numel() == 0:
        return words
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        rc = _bits_launcher("pack_bits")(mask.data_ptr(), words.data_ptr(),
                                         N, S, stream)
    build.check(rc, "pack_bits")
    pack_bits.launches += 1
    return words


pack_bits.launches = 0


def unpack_bits(words, S: int):
    """(N, W) int32 words -> (N, S) bool, W * 32 >= S.  The input is checked
    on every device; then CUDA tensors launch the kernel (counted in
    `unpack_bits.launches`) and CPU tensors run the plain version."""
    if words.dim() != 2 or words.dtype != torch.int32 \
            or not words.is_contiguous() or words.shape[1] * 32 < S:
        raise ValueError(f"unpack_bits: words must be a contiguous (N, W) "
                         f"int32 tensor with 32 W >= S={S}, got "
                         f"{words.dtype} {tuple(words.shape)}")
    if not launches_kernel(words, "unpack_bits"):
        return plain_unpack_bits(words, S)
    N, W = words.shape
    if N > 65535:
        raise ValueError(f"unpack_bits: {N} rows exceed the grid's 65535")
    bits = torch.empty((N, S), dtype=torch.bool, device=words.device)
    if bits.numel() == 0:
        return bits
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = _bits_launcher("unpack_bits")(words.data_ptr(), bits.data_ptr(),
                                           N, S, W, stream)
    build.check(rc, "unpack_bits")
    unpack_bits.launches += 1
    return bits


unpack_bits.launches = 0


def plain_delta_gaps(ts, valid):
    """(N, S) int32 offsets + bool valid -> (N, S) int16 uint16 gaps in
    plain torch: valid ? ts[s] - ts[s - 1] : 0, ts[-1] = 0."""
    prev = torch.cat([torch.zeros_like(ts[:, :1]), ts[:, :-1]], dim=1)
    return F.u16_bits(torch.where(valid, ts - prev, 0))


def plain_delta_positions(gaps):
    """(N, S) int16 uint16 gaps -> (N, S) int32 per-row inclusive cumsum in
    plain torch."""
    return torch.cumsum(F.u16_values(gaps), dim=1, dtype=torch.int32)


def _delta_launcher(name):
    fn = getattr(build.library("delta"), f"{name}_launch")
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, i64, i64, p] if name == "delta_gaps" \
            else [p, p, i64, i64, p]
        fn.restype = ctypes.c_int
    return fn


def delta_gaps(ts, valid):
    """Sorted per-row offsets -> first-order gaps, slot 0 absolute, invalid
    slots 0: (N, S) int32 + (N, S) bool -> (N, S) int16 holding the uint16
    pattern.  The inputs are checked on every device; then CUDA tensors
    launch the kernel (counted in `delta_gaps.launches`) and CPU tensors run
    the plain version."""
    if ts.dim() != 2 or ts.dtype != torch.int32 or not ts.is_contiguous() \
            or valid.shape != ts.shape or valid.dtype != torch.bool \
            or not valid.is_contiguous() or valid.device != ts.device:
        raise ValueError(f"delta_gaps: ts must be a contiguous (N, S) int32 "
                         f"tensor and valid a bool one of its shape on its "
                         f"device, got {ts.dtype} {tuple(ts.shape)}, "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if not launches_kernel(ts, "delta_gaps"):
        return plain_delta_gaps(ts, valid)
    N, S = ts.shape
    if N > 65535:
        raise ValueError(f"delta_gaps: {N} rows exceed the grid's 65535")
    gaps = torch.empty((N, S), dtype=torch.int16, device=ts.device)
    if gaps.numel() == 0:
        return gaps
    with torch.cuda.device(ts.device):
        stream = torch.cuda.current_stream(ts.device).cuda_stream
        rc = _delta_launcher("delta_gaps")(ts.data_ptr(), valid.data_ptr(),
                                           gaps.data_ptr(), N, S, stream)
    build.check(rc, "delta_gaps")
    delta_gaps.launches += 1
    return gaps


delta_gaps.launches = 0


def delta_positions(gaps):
    """(N, S) int16 uint16 gaps -> (N, S) int32 per-row inclusive cumsum
    (the gaps read as unsigned, the sum wrapping as int32).  The input is
    checked on every device; then CUDA tensors launch the kernel (counted in
    `delta_positions.launches`) and CPU tensors run the plain version."""
    if gaps.dim() != 2 or gaps.dtype != torch.int16 \
            or not gaps.is_contiguous():
        raise ValueError(f"delta_positions: gaps must be a contiguous "
                         f"(N, S) int16 tensor, got {gaps.dtype} "
                         f"{tuple(gaps.shape)}")
    if not launches_kernel(gaps, "delta_positions"):
        return plain_delta_positions(gaps)
    N, S = gaps.shape
    pos = torch.empty((N, S), dtype=torch.int32, device=gaps.device)
    if pos.numel() == 0:
        return pos
    with torch.cuda.device(gaps.device):
        stream = torch.cuda.current_stream(gaps.device).cuda_stream
        rc = _delta_launcher("delta_positions")(gaps.data_ptr(),
                                                pos.data_ptr(), N, S, stream)
    build.check(rc, "delta_positions")
    delta_positions.launches += 1
    return pos


delta_positions.launches = 0
