"""The fused local expand over one chunk of consecutive edge ids (paper
sec. 3.4; DESIGN.md sec. 9), the port of `repro/kernels/expand.py:
expand_chunk` and `expand_chunk_values`.

  stage 1  workload map    k = max{l <= front_total : cumul[l] <= gid}
  stage 2  neighbour gather u = front[k]; v = row_idx[col_off[u] + gid -
                           cumul[k]]
  stage 3  visited filter  bitmap test + first occurrence within the tile

`expand_chunk` launches the CUDA kernel `csrc/expand.cu` for CUDA tensors
and runs `plain_expand_chunk`, the same formulas in torch, for CPU tensors.
Both equal the Pallas kernel lane for lane, masked lanes included.  The
returned `won` mask is a subset of `valid & ~visited[v]` that keeps every
vertex's first slot, so it elects the same winners under
`frontier.winner_dedup` as the plain scan (DESIGN.md sec. 9.2).

`expand_chunk_values` is the value programs' twin (CC, SSSP, multi-source
BFS): stages 1 and 2 without the filter, returning (v, payload[k], clipped
CSC address, valid).  It launches its kernel in `csrc/expand.cu` for CUDA
tensors and runs `plain_expand_chunk_values` for CPU tensors; both follow
the Pallas kernel on every lane.  On masked lanes the JAX reference scan
(`searchsorted` on the unclipped cumsum) gives another k, so another
payload and address; only valid lanes reach the program's result.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import frontier as F
from repro_torch.kernels import build
from repro_torch.kernels.select import launches_kernel

I32_MAX = 2**31 - 1


def pick_tile(e: int, tile: int) -> int:
    """Largest divisor of the chunk length <= tile (`_pick_tile` of the JAX
    kernel): the per-tile dedup must cut the chunk into equal tiles."""
    t = min(tile, e)
    while e % t:
        t -= 1
    return t


def plain_expand_chunk(start: int, n_lanes: int, cumul, all_front,
                       front_total, col_off, row_idx, words, *,
                       tile: int = 512):
    """The kernel's formulas in plain torch, on any device.

    Returns (v, won, u): (n_lanes,) int32 candidate local rows (masked lanes
    0), bool winners of the visited filter, int32 parent frontier cols."""
    dev = cumul.device
    _, _, u, addr, valid = _map_gather(start, n_lanes, cumul, all_front,
                                       front_total, col_off)
    v = torch.where(valid, row_idx[addr.clamp(0, row_idx.shape[0] - 1)], 0)
    v = v.to(torch.int32)
    w = (v >> 5).clamp(0, words.shape[0] - 1)
    unvis = valid & (((words[w] >> (v & 31)) & 1) == 0)
    # first occurrence of v among the tile's live lanes: stable sort by
    # (tile, v), first of each equal run
    tile = pick_tile(n_lanes, tile)
    lane = torch.arange(n_lanes, device=dev)
    key = torch.where(valid, (lane // tile) * 2**32 + v.to(torch.int64),
                      torch.iinfo(torch.int64).max)
    ks, order = torch.sort(key, stable=True)
    first_sorted = torch.ones_like(ks, dtype=torch.bool)
    first_sorted[1:] = ks[1:] != ks[:-1]
    first = torch.empty_like(first_sorted)
    first[order] = first_sorted
    return v, unvis & first, u


def _map_gather(start, n_lanes, cumul, all_front, front_total, col_off):
    """Stages 1 and 2 in plain torch: (gid, k, u, address before its clip,
    valid)."""
    dev = cumul.device
    ncl = all_front.shape[0]
    gid = start + torch.arange(n_lanes, dtype=torch.int32, device=dev)
    idx = torch.arange(cumul.shape[0], device=dev)
    cc = torch.where(idx <= front_total, cumul, I32_MAX).to(torch.int32)
    k = torch.searchsorted(cc, gid, right=True, out_int32=True) - 1
    k = k.clamp(0, ncl - 1)
    u = all_front.clamp(0, ncl - 1)[k]
    addr = F.wrap_i32(col_off[u].long() + gid.long() - cumul[k].long())
    valid = gid < cumul[front_total]
    return gid, k, u, addr, valid


def plain_expand_chunk_values(start: int, n_lanes: int, cumul, all_front,
                              all_payload, front_total, col_off, row_idx):
    """The value kernel's formulas in plain torch, on any device.

    Returns (v, pay, addr, valid): (n_lanes,) int32 candidate local rows
    (masked lanes 0), the carried payload[k], int32 clipped CSC addresses,
    bool live-lane mask."""
    _, k, _, addr, valid = _map_gather(start, n_lanes, cumul, all_front,
                                       front_total, col_off)
    addr = addr.clamp(0, row_idx.shape[0] - 1)
    v = torch.where(valid, row_idx[addr], 0).to(torch.int32)
    return v, all_payload[k], addr, valid


def _launcher():
    fn = build.library("expand").expand_chunk_launch
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i32, i32, i32, p, p, i32, p, p, p, i64, p, i64, p, p,
                       p, p]
        fn.restype = ctypes.c_int
    return fn


def _check_tensors(what, dev, **tensors):
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous int32 "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")


def expand_chunk(start: int, n_lanes: int, cumul, all_front, front_total,
                 col_off, row_idx, words, *, tile: int = 512):
    """One chunk of the fused expand over edge ids start .. start+n_lanes-1.

    cumul: (ncl + 1,) int32 exclusive cumsum of the frontier degrees;
    all_front: (ncl,) int32 gathered frontier; front_total: () int32 live
    frontier length; col_off / row_idx: the block's CSC; words: the packed
    visited bitmap as int32 bit patterns.  CUDA tensors launch the kernel
    (counted in `expand_chunk.launches`); CPU tensors run the plain version.
    """
    if not launches_kernel(cumul, "expand_chunk"):
        return plain_expand_chunk(start, n_lanes, cumul, all_front,
                                  front_total, col_off, row_idx, words,
                                  tile=tile)
    dev = cumul.device
    _check_tensors("expand_chunk", dev, cumul=cumul, all_front=all_front,
                   front_total=front_total, col_off=col_off,
                   row_idx=row_idx, words=words)
    ncl = all_front.shape[0]
    if (cumul.shape != (ncl + 1,) or col_off.shape != (ncl + 1,)
            or front_total.numel() != 1 or row_idx.dim() != 1
            or words.dim() != 1):
        raise ValueError(
            f"expand_chunk: shapes cumul {tuple(cumul.shape)}, all_front "
            f"{tuple(all_front.shape)}, front_total "
            f"{tuple(front_total.shape)}, col_off {tuple(col_off.shape)}, "
            f"row_idx {tuple(row_idx.shape)}, words {tuple(words.shape)}")
    if ncl < 1 or row_idx.shape[0] < 1 or words.shape[0] < 1 \
            or start < 0 or start + n_lanes > I32_MAX:
        raise ValueError("expand_chunk: empty CSC/bitmap or edge ids past "
                         "int32")
    tile = pick_tile(n_lanes, tile)
    v = torch.empty(n_lanes, dtype=torch.int32, device=dev)
    won = torch.empty(n_lanes, dtype=torch.bool, device=dev)
    u = torch.empty(n_lanes, dtype=torch.int32, device=dev)
    if n_lanes == 0:
        return v, won, u
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(start, n_lanes, tile, cumul.data_ptr(), all_front.data_ptr(),
                ncl, front_total.data_ptr(), col_off.data_ptr(),
                row_idx.data_ptr(), row_idx.shape[0], words.data_ptr(),
                words.shape[0], v.data_ptr(), won.data_ptr(), u.data_ptr(),
                stream)
    build.check(rc, "expand_chunk")
    expand_chunk.launches += 1
    return v, won, u


expand_chunk.launches = 0


def _values_launcher():
    fn = build.library("expand").expand_chunk_values_launch
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i32, i32, p, p, p, i32, p, p, p, i64, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def expand_chunk_values(start: int, n_lanes: int, cumul, all_front,
                        all_payload, front_total, col_off, row_idx):
    """One chunk of the value-carrying expand over edge ids start ..
    start + n_lanes - 1 (`scan_relax`, every top-down level of CC, SSSP and
    multi-source BFS).

    all_payload: (ncl,) int32 values aligned with all_front; the other
    inputs as for `expand_chunk`.  Returns (v, pay, addr, valid).  CUDA
    tensors launch the kernel (counted in `expand_chunk_values.launches`);
    CPU tensors run the plain version.  The inputs are checked on every
    device."""
    dev = cumul.device
    tensors = dict(cumul=cumul, all_front=all_front, all_payload=all_payload,
                   front_total=front_total, col_off=col_off, row_idx=row_idx)
    _check_tensors("expand_chunk_values", dev, **tensors)
    ncl = all_front.shape[0]
    if (cumul.shape != (ncl + 1,) or col_off.shape != (ncl + 1,)
            or all_payload.shape != (ncl,) or front_total.numel() != 1
            or row_idx.dim() != 1):
        raise ValueError(
            "expand_chunk_values: shapes "
            f"{ {k: tuple(t.shape) for k, t in tensors.items()} }")
    if ncl < 1 or row_idx.shape[0] < 1 or start < 0 \
            or start + n_lanes > I32_MAX:
        raise ValueError("expand_chunk_values: empty CSC or edge ids past "
                         "int32")
    if not launches_kernel(cumul, "expand_chunk_values"):
        return plain_expand_chunk_values(start, n_lanes, cumul, all_front,
                                         all_payload, front_total, col_off,
                                         row_idx)
    out = [torch.empty(n_lanes, dtype=torch.int32, device=dev)
           for _ in range(3)] + [torch.empty(n_lanes, dtype=torch.bool,
                                             device=dev)]
    if n_lanes == 0:
        return tuple(out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _values_launcher()(
            start, n_lanes, cumul.data_ptr(), all_front.data_ptr(),
            all_payload.data_ptr(), ncl, front_total.data_ptr(),
            col_off.data_ptr(), row_idx.data_ptr(), row_idx.shape[0],
            *(o.data_ptr() for o in out), stream)
    build.check(rc, "expand_chunk_values")
    expand_chunk_values.launches += 1
    return tuple(out)


expand_chunk_values.launches = 0
