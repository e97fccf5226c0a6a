"""The fused expand's stages 1 and 3 as standalone ops, the port of
`repro/kernels/_binsearch_map.py` and `repro/kernels/_visited_filter.py`.

  stage 1  workload map    k[t] = max{l : cumul[l] <= gids[t]}, 0 where
                           none, over a `clip_cumul`-clipped cumsum
  stage 3  visited filter  won[t] = valid[t], bit v[t] unset in the visited
                           words, and the first valid lane of its tile that
                           carries v[t]

`map_workload` and `filter_tile` are the plain stage functions: the
formulas of the Pallas kernel bodies (`map_workload_tile`, `filter_tile`)
in torch, on any device, and the plain versions of the two ops.
`kernels.expand.plain_expand_chunk` composes them, as the Pallas
`expand_chunk` composes its stages.

`binsearch_map` and `visited_filter` are the stage ops: each launches its
CUDA kernel in `csrc/stages.cu` for CUDA tensors (counted in
`fn.launches`) and runs its plain version for CPU tensors.  Both equal the
Pallas kernels on every lane, masked lanes included.  `binsearch_map`'s
kernel searches block by block: one warp finds the cumul slots of the
block's smallest and largest gid, and the lanes search only between them
(in shared memory where that span is short), so its gids need only be
sorted within a Pallas tile; `window`, the width of the TPU kernel's
broadcast-compare, has no meaning there, so the port leaves it out.  The
fused B1, B7, B8 and B9 map their consecutive gids with the same warp
search and a walk (`stage::workload_map_block` in `csrc/stages.cuh`).
`visited_filter`'s kernel is B1's stage 3: each lane claims its vertex in
a hash table in shared memory, and the smallest lane of each vertex wins.

Words are the uint32 visited bitmap as int32 bit patterns
(`core.frontier.pack_bitmap`); the plain test masks with `& 1` after the
(arithmetic) shift.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.select import launches_kernel

I32_MAX = 2**31 - 1
MAX_TILE = 1024            # one CUDA block per visited_filter tile


def clip_cumul(cumul, front_total):
    """Entries past the live frontier (index > front_total) -> I32_MAX, so
    every masked lane maps to k = front_total."""
    idx = torch.arange(cumul.shape[0], device=cumul.device)
    return torch.where(idx <= front_total, cumul, I32_MAX).to(torch.int32)


def map_workload(gids, cumul):
    """Stage 1 in plain torch: k[t] = max{l : cumul[l] <= gids[t]} over a
    non-decreasing int32 cumul, 0 where no entry is <= gids[t] (the Pallas
    kernel's value there; the oracle's searchsorted gives -1)."""
    k = torch.searchsorted(cumul, gids, right=True, out_int32=True) - 1
    return k.clamp_min(0)


def filter_tile(v, valid, words, tile: int):
    """Stage 3 in plain torch over consecutive tiles of `tile` lanes: bitmap
    test plus first occurrence of v among the tile's valid lanes (a stable
    sort by (tile, v), first of each equal run -- not the Pallas kernel's
    dense (tile, tile) compare, which would be quadratic in the tile)."""
    n = v.shape[0]
    w = (v >> 5).clamp(0, words.shape[0] - 1)
    unvis = valid & (((words[w] >> (v & 31)) & 1) == 0)
    lane = torch.arange(n, device=v.device)
    key = torch.where(valid, (lane // tile) * 2**32 + v.to(torch.int64),
                      torch.iinfo(torch.int64).max)
    ks, order = torch.sort(key, stable=True)
    first_sorted = torch.ones_like(ks, dtype=torch.bool)
    first_sorted[1:] = ks[1:] != ks[:-1]
    first = torch.empty_like(first_sorted)
    first[order] = first_sorted
    return unvis & first


def _check_tile(what, e: int, tile: int) -> None:
    if tile < 1 or e % tile:
        raise ValueError(f"{what}: {e} lanes are not a multiple of tile "
                         f"{tile}; pad them to a multiple of the tile")


def _check_tensors(what, dev, dtype, **tensors):
    for name, t in tensors.items():
        if t.device != dev or t.dtype != dtype or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous 1-D "
                             f"{dtype} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _launcher(name, argtypes):
    fn = getattr(build.library("stages"), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def binsearch_map(cumul, gids, *, tile: int = 512):
    """k[t] = max{l : cumul[l] <= gids[t]} for gids ascending within each
    tile (consecutive edge ids in the BFS) over a non-decreasing int32
    cumul, clipped by the caller (`clip_cumul`); 0 where no entry is <=
    gids[t].

    tile: the Pallas grid's block; as there, the gids must be a multiple
    of it (else ValueError).  The CUDA kernel maps blocks of 2048 lanes:
    the slots of a block's smallest and largest gid bound every lane's,
    so a block may straddle tiles, and it equals `map_workload` on any
    gids.  CUDA tensors launch the kernel (counted in
    `binsearch_map.launches`); CPU tensors run its plain version
    `map_workload`.  The inputs are checked on every device."""
    dev = gids.device
    _check_tensors("binsearch_map", dev, torch.int32, cumul=cumul, gids=gids)
    e = gids.shape[0]
    _check_tile("binsearch_map", e, tile)
    if not launches_kernel(gids, "binsearch_map"):
        return map_workload(gids, cumul)
    k = torch.empty(e, dtype=torch.int32, device=dev)
    if e == 0:
        return k
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _launcher("binsearch_map", [p, i32, p, i64, p, p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(cumul.data_ptr(), cumul.shape[0], gids.data_ptr(), e,
                k.data_ptr(), stream)
    build.check(rc, "binsearch_map")
    binsearch_map.launches += 1
    return k


binsearch_map.launches = 0


def visited_filter(v, valid, words, *, tile: int = 256):
    """won (bool, same shape as v): the first valid lane of each tile that
    carries an unvisited vertex.  Dedup is per tile, as in the Pallas
    kernel; a caller's `winner_dedup` handles duplicates across tiles.

    v: (E,) int32; valid: (E,) bool; words: the packed visited bitmap as
    int32 bit patterns, at least one word.  E must be a multiple of `tile`
    (else ValueError).  The CUDA kernel gives a tile's lanes to the
    threads of one block, so it takes tile <= 1024, and dedups each tile
    through a hash table in shared memory (the next power of two >= 2 *
    tile slots of 8 B).  CUDA tensors launch the kernel (counted in
    `visited_filter.launches`); CPU tensors run its plain version
    `filter_tile`.  The inputs are checked on every device."""
    dev = v.device
    _check_tensors("visited_filter", dev, torch.int32, v=v, words=words)
    _check_tensors("visited_filter", dev, torch.bool, valid=valid)
    e = v.shape[0]
    if valid.shape[0] != e or words.shape[0] < 1:
        raise ValueError(f"visited_filter: v {tuple(v.shape)}, valid "
                         f"{tuple(valid.shape)}, words {tuple(words.shape)}")
    _check_tile("visited_filter", e, tile)
    if not launches_kernel(v, "visited_filter"):
        return filter_tile(v, valid, words, tile)
    if tile > MAX_TILE:
        raise ValueError(f"visited_filter: tile {tile} > {MAX_TILE}, the "
                         f"CUDA kernel's block limit")
    won = torch.empty(e, dtype=torch.bool, device=dev)
    if e == 0:
        return won
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _launcher("visited_filter", [p, p, p, i64, i64, i32, p, p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(v.data_ptr(), valid.data_ptr(), words.data_ptr(),
                words.shape[0], e, tile, won.data_ptr(), stream)
    build.check(rc, "visited_filter")
    visited_filter.launches += 1
    return won


visited_filter.launches = 0
