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

`make_expand_fn` / `make_value_expand_fn` build the chunk hooks the
engines call (and `BFSConfig(expand_fn=...)` takes), on the kernel or the
plain path.  `local_expand` is the standalone fused op over a whole
frontier: the chunk loop, winner selection and the canonical ascending
compaction (stage 4), the port of `repro.kernels.local_expand`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import frontier as F
from repro_torch.core.types import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels import stages as S
from repro_torch.kernels.select import chunk_hook, launches_kernel, \
    resolve_path

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
    """The kernel's formulas in plain torch, on any device: stage 1 and 3
    are the plain stage functions `stages.map_workload` and
    `stages.filter_tile`, as the Pallas kernel composes its stages.

    Returns (v, won, u): (n_lanes,) int32 candidate local rows (masked lanes
    0), bool winners of the visited filter, int32 parent frontier cols."""
    _, _, u, addr, valid = _map_gather(start, n_lanes, cumul, all_front,
                                       front_total, col_off)
    v = torch.where(valid, row_idx[addr.clamp(0, row_idx.shape[0] - 1)], 0)
    v = v.to(torch.int32)
    won = S.filter_tile(v, valid, words, pick_tile(n_lanes, tile))
    return v, won, u


def _map_gather(start, n_lanes, cumul, all_front, front_total, col_off):
    """Stages 1 and 2 in plain torch: (gid, k, u, address before its clip,
    valid)."""
    ncl = all_front.shape[0]
    gid = start + torch.arange(n_lanes, dtype=torch.int32,
                               device=cumul.device)
    k = S.map_workload(gid, S.clip_cumul(cumul, front_total))
    k = k.clamp_max(ncl - 1)
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


# ----------------------------------------------------------------------------
# Engine hooks: the chunk functions FrontierEngine threads into its scans
# ----------------------------------------------------------------------------

def make_expand_fn(*, path: str = "auto", tile: int = 512):
    """The chunk hook of the top-down scan (`core.frontier.expand_frontier`,
    `BFSConfig(expand_fn=...)`):

        (start, n_lanes, cumul, all_front, front_total, col_off, row_idx,
         words) -> (v, eligible, u)

    over edge ids start .. start + n_lanes - 1, with `words` the packed
    visited bitmap (int32 bit patterns) that the scan keeps across chunks,
    so a chunk needs no host read.  (JAX's hook takes the gids and the
    visited mask, and asks for the words with `accepts_words`; the port's
    scan always passes them.)  path (`select.chunk_hook`): "kernel" is
    `expand_chunk` (B1) and refuses CPU tensors, "reference"
    `plain_expand_chunk`, "auto" `expand_chunk`, which picks by the
    tensors' device.  tile: the stage-3 dedup tile."""
    return chunk_hook(expand_chunk, plain_expand_chunk, path, tile=tile)


def make_value_expand_fn(*, path: str = "auto"):
    """The chunk hook of the value programs' top-down scan
    (`algos.program.scan_relax`):

        (start, n_lanes, cumul, all_front, all_payload, front_total,
         col_off, row_idx) -> (v, payload, addr, valid)

    path as for `make_expand_fn`: "kernel" is `expand_chunk_values` (B8),
    "reference" `plain_expand_chunk_values`.  Unlike JAX's it takes no
    tile: the value kernel has no tile stage."""
    return chunk_hook(expand_chunk_values, plain_expand_chunk_values, path)


# ----------------------------------------------------------------------------
# The standalone fused op (stage 4 compaction included)
# ----------------------------------------------------------------------------

class LocalExpandOut(NamedTuple):
    verts: torch.Tensor          # (n_rows,) int32 discovered local rows,
                                 # ascending, pad -1
    parents: torch.Tensor        # (n_rows,) int32 winning parent's local
                                 # col, pad -1
    count: torch.Tensor          # () int32 number of discoveries
    visited: torch.Tensor        # (n_rows,) bool mask, discoveries set
    edges_scanned: torch.Tensor  # () int64 live edges of the frontier,
                                 # exact (JAX's uint32 wraps)


def local_expand(frontier, csc, visited, *, path: str = "auto",
                 edge_chunk: int = 2048, tile: int = 512,
                 dedup: str = "scatter", device=None) -> LocalExpandOut:
    """One fused local frontier expansion (the paper's column scan), the
    port of `repro.kernels.local_expand`.

    frontier: padded (L,) int32 local col ids (pad -1), or a (front, count)
              pair when the live count is already known.
    csc:      (col_off, row_idx) pair or any object with those attributes.
    visited:  (n_rows,) bool mask (no sink slot); a new mask with the
              discoveries set is returned, the input is not written.
    path:     "auto" | "kernel" | "reference" on the tensors' device: the
              chunk loop through B1 (`expand_chunk`, with the visited words
              kept by `set_bits`) or through the plain reference formulas
              (`core.frontier.reference_expand_chunk`).
    device:   tensors stay where they are and must share one device
              (`device`, if it is named); inputs that are not tensors
              (numpy arrays, ints) join them, or, where no input is a
              tensor, go to `device`: CUDA unless named, raising without a
              card (`core.types.resolve_device`).

    Returns the discoveries in canonical ascending order with their winning
    parents, equal on both paths and to the JAX op.  One host read: the
    frontier's edge total."""
    if hasattr(csc, "col_off"):
        col_off, row_idx = csc.col_off, csc.row_idx
    else:
        col_off, row_idx = csc
    if isinstance(frontier, (tuple, list)):
        front, count = frontier
    else:
        front, count = frontier, None
    devs = {t.device for t in (col_off, row_idx, front, count, visited)
            if isinstance(t, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(f"local_expand: tensors on several devices "
                         f"{sorted(map(str, devs))}")
    dev = next(iter(devs)) if devs else resolve_device(device)
    want = torch.device(device) if device is not None else dev
    if want.type != dev.type or want.index not in (None, dev.index):
        raise ValueError(f"local_expand: tensors on {dev}, device={want}")
    col_off = torch.as_tensor(col_off, dtype=torch.int32,
                              device=dev).contiguous()
    row_idx = torch.as_tensor(row_idx, dtype=torch.int32,
                              device=dev).contiguous()
    front = torch.as_tensor(front, dtype=torch.int32, device=dev)
    if count is None:
        count = (front >= 0).sum(dtype=torch.int32)
    count = torch.as_tensor(count, dtype=torch.int32, device=dev).reshape(())
    ncl = col_off.shape[0] - 1
    if front.shape[0] > ncl:
        raise ValueError(f"frontier length {front.shape[0]} exceeds the "
                         f"{ncl} CSC columns")
    if front.shape[0] < ncl:   # pad to the column count the kernels index
        front = torch.cat([front, torch.full((ncl - front.shape[0],), -1,
                                             dtype=torch.int32, device=dev)])
    visited = torch.as_tensor(visited, dtype=torch.bool, device=dev)
    kernel = resolve_path(path, dev, knob="path") == "kernel"
    return _local_expand(
        front.contiguous(), count, col_off, row_idx, visited,
        expand_fn=make_expand_fn(path="kernel", tile=tile) if kernel
        else None, edge_chunk=edge_chunk, dedup=dedup)


def _local_expand(front, front_total, col_off, row_idx, visited, *,
                  expand_fn, edge_chunk: int, dedup: str) -> LocalExpandOut:
    """`local_expand` on normalised tensors; expand_fn: a chunk hook
    (`make_expand_fn`), None = the reference formulas.

    A discovery is recorded only as its parent (>= 0; -1 = none).  Each
    vertex is won once in the whole call, so the parent scatter is a
    scatter-max where a non-winner writes max's identity -1 at its own
    lane's row, instead of every masked lane meeting on one sink slot."""
    dev = col_off.device
    n_rows = visited.shape[0]
    cumul, total = F.scan_plan(col_off, front, front_total)
    total = int(total)
    parent = torch.full((n_rows,), -1, dtype=torch.int32, device=dev)
    words = F.pack_bitmap(visited) if expand_fn is not None else None
    lanes = torch.arange(edge_chunk, dtype=torch.int32, device=dev)
    own = lanes.long() % n_rows
    for start in range(0, total, edge_chunk):
        if expand_fn is None:
            v, u, _, _, valid = F.reference_expand_chunk(
                start + lanes, cumul, front, front_total, col_off, row_idx)
            elig = valid & ~visited[v] & (parent[v] < 0)
        else:
            v, elig, u = expand_fn(start, edge_chunk, cumul, front,
                                   front_total, col_off, row_idx, words)
        win = F.winner_dedup(v, elig, n_rows, method=dedup)
        parent.scatter_reduce_(0, torch.where(win, v.long(), own),
                               torch.where(win, u, -1), "amax")
        if words is not None:
            F.set_bits(words, v, win)

    # stage 4: compaction, canonical ascending (the repo-wide frontier order)
    new = parent >= 0
    rows = torch.arange(n_rows, dtype=torch.int32, device=dev)
    srt = torch.sort(torch.where(new, rows, I32_MAX)).values
    ok = srt < I32_MAX
    return LocalExpandOut(
        verts=torch.where(ok, srt, -1),
        parents=torch.where(ok, parent[srt.clamp(0, n_rows - 1)], -1),
        count=new.sum(dtype=torch.int32), visited=visited | new,
        edges_scanned=torch.tensor(total, dtype=torch.int64, device=dev))
