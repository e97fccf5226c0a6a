"""The fused local expand over one chunk of consecutive edge ids (paper
sec. 3.4; DESIGN.md sec. 9), the port of `repro/kernels/expand.py:
expand_chunk`.

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
"""
from __future__ import annotations

import ctypes

import torch

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
    ncl = all_front.shape[0]
    nnz_cap = row_idx.shape[0]
    gid = start + torch.arange(n_lanes, dtype=torch.int32, device=dev)
    idx = torch.arange(cumul.shape[0], device=dev)
    cc = torch.where(idx <= front_total, cumul, I32_MAX).to(torch.int32)
    k = torch.searchsorted(cc, gid, right=True, out_int32=True) - 1
    k = k.clamp(0, ncl - 1)
    u = all_front.clamp(0, ncl - 1)[k]
    addr = col_off[u] + gid - cumul[k]
    valid = gid < cumul[front_total]
    v = torch.where(valid, row_idx[addr.clamp(0, nnz_cap - 1)], 0)
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


def _launcher():
    fn = build.library("expand").expand_chunk_launch
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i32, i32, i32, p, p, i32, p, p, p, i64, p, i64, p, p,
                       p, p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(dev, **tensors):
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"expand_chunk: {name} on {t.device}, cumul on "
                             f"{dev}")
        if t.dtype != torch.int32:
            raise ValueError(f"expand_chunk: {name} must be int32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"expand_chunk: {name} must be contiguous")


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
    _check_cuda(dev, cumul=cumul, all_front=all_front,
                front_total=front_total, col_off=col_off, row_idx=row_idx,
                words=words)
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
