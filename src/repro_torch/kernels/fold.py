"""The fold-path kernels (DESIGN.md sec. 10), the port of
`repro/kernels/fold.py`: prefix-sum row compaction and the bitmap codec's
bit packing.

`compact_rows` front-packs each row's masked entries, in order, and pads
with per-channel fills: the argsort replacement of `core.frontier.
compact_blocks` (`dist.exchange.expand_exchange`, every top-down level),
`compact_offsets` (the bitmap decode, `pack_blocks`, `owned_to_front`) and
`expand_exchange_values`.  A channel given as `SLOT_OFFSETS` is each
slot's own offset t.  For CUDA tensors it launches `csrc/compact.cu` for
every channel together: each tile of a row counts its kept slots, a scan
turns the counts into offsets, and each tile writes its runs and its share
of the fills, with no (N, S) prefix tensor; for CPU tensors it runs
`plain_compact_rows`, a stable argsort of ~mask.  Both are bit-identical:
the output is fully determined by the mask.

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


SLOT_OFFSETS = F.SLOT_OFFSETS


def plain_compact_rows(mask, arrays, fills):
    """Stable-argsort compaction in plain torch, on any device (a
    `SLOT_OFFSETS` channel is the argsort's order itself)."""
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    keep = torch.gather(mask, 1, order)
    packed = tuple(
        torch.where(keep, order.to(torch.int32) if a is SLOT_OFFSETS
                    else torch.gather(a, 1, order),
                    torch.tensor(int(f), dtype=torch.int32,
                                 device=mask.device))
        for a, f in zip(arrays, fills))
    return packed, mask.sum(dim=1, dtype=torch.int32)


def _compact_lib():
    lib = build.library("compact")
    fn = lib.compact_rows_launch
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ptrs = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [p, i32, i64, i32, ptrs, ptrs,
                       ctypes.POINTER(ctypes.c_int), p, p, p,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = i32
        lib.compact_rows_scratch_bytes.argtypes = [i32, i64]
        lib.compact_rows_scratch_bytes.restype = i64
        lib.compact_rows_max_channels.argtypes = []
        lib.compact_rows_max_channels.restype = i32
    return lib


def compact_rows(mask, arrays, fills):
    """Front-pack each row's valid entries, preserving order.

    mask: (N, S) bool validity; arrays: aligned (N, S) int32 channels, or
    `SLOT_OFFSETS` for a channel holding each slot's offset t; fills:
    per-channel pad values.  Returns (tuple of packed (N, S) int32 arrays,
    (N,) int32 counts).  CUDA tensors launch the kernel once for up to four
    channels (counted in `compact_rows.launches`, its form, "vector" or
    "general", in `compact_rows.last_form`); CPU tensors run the plain
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
        if a is not SLOT_OFFSETS and (
                a.shape != mask.shape or a.dtype != torch.int32
                or a.device != dev or not a.is_contiguous()):
            raise ValueError(
                f"compact_rows: channels must be contiguous int32 "
                f"{tuple(mask.shape)} on {dev} or SLOT_OFFSETS, got "
                f"{a.dtype} {tuple(a.shape)} on {a.device}")
    N, S = mask.shape
    outs = tuple(torch.empty((N, S), dtype=torch.int32, device=dev)
                 for _ in arrays)
    counts = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0 or S == 0:
        return outs, counts.zero_()
    lib = _compact_lib()
    per = lib.compact_rows_max_channels()
    scratch = torch.empty(lib.compact_rows_scratch_bytes(N, S),
                          dtype=torch.uint8, device=dev)
    vector = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for c0 in range(0, max(len(arrays), 1), per):
            group = range(c0, min(c0 + per, len(arrays)))
            n = len(group)
            src = (ctypes.c_longlong * n)(*[
                0 if arrays[c] is SLOT_OFFSETS else arrays[c].data_ptr()
                for c in group])
            out = (ctypes.c_longlong * n)(*[outs[c].data_ptr()
                                            for c in group])
            fill = (ctypes.c_int * n)(*[fills[c] for c in group])
            rc = lib.compact_rows_launch(
                mask.data_ptr(), N, S, n, src, out, fill, counts.data_ptr(),
                scratch.data_ptr(), stream, ctypes.byref(vector))
            build.check(rc, "compact_rows")
            compact_rows.launches += 1
    compact_rows.last_form = "vector" if vector.value else "general"
    return outs, counts


compact_rows.launches = 0
compact_rows.last_form = None


def plain_pack_bits(mask):
    """(N, S) bool -> (N, ceil(S/32)) int32 words in plain torch."""
    return F.pack_bitmap(mask)


def plain_unpack_bits(words, S: int):
    """(N, W) int32 words -> (N, S) bool in plain torch."""
    return F.unpack_bitmap(words, S)


def _launch_bits(name, *args):
    """Launch kernel `name` of `csrc/bits.cu`; returns the form it chose:
    "vector" (16-byte accesses, rows of bytes 16-byte aligned) or "general"
    (a byte a thread)."""
    fn = getattr(build.library("bits"), f"{name}_launch")
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        form = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = ([p, p, i64, i64, p, form] if name == "pack_bits"
                       else [p, p, i64, i64, i64, p, form])
        fn.restype = ctypes.c_int
    vector = ctypes.c_int(0)
    build.check(fn(*args, ctypes.byref(vector)), name)
    return "vector" if vector.value else "general"


def pack_bits(mask):
    """(N, S) bool -> (N, ceil(S/32)) int32 little-endian words, pad bits 0.
    The input is checked on every device; then CUDA tensors launch the
    kernel (counted in `pack_bits.launches`, its form in
    `pack_bits.last_form`) and CPU tensors run the plain version."""
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
        pack_bits.last_form = _launch_bits(
            "pack_bits", mask.data_ptr(), words.data_ptr(), N, S, stream)
    pack_bits.launches += 1
    return words


pack_bits.launches = 0
pack_bits.last_form = None


def unpack_bits(words, S: int):
    """(N, W) int32 words -> (N, S) bool, W * 32 >= S.  The input is checked
    on every device; then CUDA tensors launch the kernel (counted in
    `unpack_bits.launches`, its form in `unpack_bits.last_form`) and CPU
    tensors run the plain version."""
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
        unpack_bits.last_form = _launch_bits(
            "unpack_bits", words.data_ptr(), bits.data_ptr(), N, S, W,
            stream)
    unpack_bits.launches += 1
    return bits


unpack_bits.launches = 0
unpack_bits.last_form = None


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
