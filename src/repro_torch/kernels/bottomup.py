"""The fused bottom-up parent search over one chunk of consecutive edge ids
(DESIGN.md sec. 11), the port of `repro/kernels/bottomup.py:
bottomup_chunk` and `bottomup_chunk_values`.

  stage 1  workload map    r = max{l : cc[l] <= gid} over the masked-degree
                           cumsum clipped BY VALUE (cc = cumul where
                           cumul < total, else I32_MAX)
  stage 2  neighbour gather c = col_idx[row_off[r] + gid - cc[r]] (CSR)
  stage 3  frontier test   blocked-bitmap membership of c
                           (`core.frontier.test_bit_blocks` addressing)

`bottomup_chunk` returns (r, c, hit) for the BFS step;
`bottomup_chunk_values` returns (r, dense_pay[c], clipped CSR address, hit)
for the value programs' pull scan.  Each launches its CUDA kernel in
`csrc/bottomup.cu` for CUDA tensors and runs its plain version, the same
formulas in torch, for CPU tensors.  Both equal the Pallas kernels lane for
lane, masked lanes included.  On masked lanes (gid >= total) the JAX
reference scans (`core.frontier.reference_bottomup_chunk` and
`reference_bottomup_values_chunk`, `searchsorted` on the unclipped cumsum)
give another r and address; only `hit` lanes reach the search's result,
where all agree.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import frontier as F
from repro_torch.kernels import build
from repro_torch.kernels.select import launches_kernel

I32_MAX = 2**31 - 1


def _plain_scan(start, n_lanes, cumul, total, row_off, col_idx, words,
                block):
    """Stages 1-3 in plain torch: (r, clipped addr, c, hit)."""
    dev = cumul.device
    nrl = row_off.shape[0] - 1
    nnz_cap = col_idx.shape[0]
    gid = start + torch.arange(n_lanes, dtype=torch.int32, device=dev)
    cc = torch.where(cumul < total, cumul, I32_MAX).to(torch.int32)
    r = torch.searchsorted(cc, gid, right=True, out_int32=True) - 1
    r = r.clamp(0, nrl - 1)
    addr = F.wrap_i32(row_off[r].long() + gid.long() - cc[r].long())
    addr = addr.clamp(0, nnz_cap - 1)
    valid = gid < total
    c = torch.where(valid, col_idx[addr], 0).to(torch.int32)
    W = (block + 31) // 32
    off = c % block
    w = ((c // block) * W + (off >> 5)).clamp(0, words.shape[0] - 1)
    hit = valid & (((words[w] >> (off & 31)) & 1) != 0)
    return r, addr, c, hit


def plain_bottomup_chunk(start: int, n_lanes: int, cumul, total, row_off,
                         col_idx, words, *, block: int):
    """The kernel's formulas in plain torch, on any device.

    Returns (r, c, hit): (n_lanes,) int32 candidate local rows, int32
    neighbour local cols (masked lanes 0), bool frontier membership."""
    r, _, c, hit = _plain_scan(start, n_lanes, cumul, total, row_off,
                               col_idx, words, block)
    return r, c, hit


def plain_bottomup_chunk_values(start: int, n_lanes: int, cumul, total,
                                row_off, col_idx, words, dense_pay, *,
                                block: int):
    """The value kernel's formulas in plain torch, on any device.

    Returns (r, pay, addr, hit): (n_lanes,) int32 candidate local rows, the
    pulled values dense_pay[c] (c = 0 on masked lanes), int32 clipped CSR
    addresses, bool frontier membership."""
    r, addr, c, hit = _plain_scan(start, n_lanes, cumul, total, row_off,
                                  col_idx, words, block)
    pay = dense_pay[c.clamp(0, dense_pay.shape[0] - 1)]
    return r, pay, addr, hit


def _check(what, start, n_lanes, block, **tensors):
    """The inputs every device must satisfy."""
    dev = tensors["cumul"].device
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous int32 "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")
    row_off = tensors["row_off"]
    nrl = row_off.shape[0] - 1
    shapes = {k: tuple(t.shape) for k, t in tensors.items()}
    if (tensors["cumul"].shape != (nrl + 1,)
            or tensors["total"].numel() != 1
            or any(tensors[k].dim() != 1
                   for k in ("col_idx", "words", "dense_pay")
                   if k in tensors)):
        raise ValueError(f"{what}: shapes {shapes}")
    if nrl < 1 or any(tensors[k].shape[0] < 1 for k in
                      ("col_idx", "words", "dense_pay") if k in tensors) \
            or block < 1 or start < 0 or start + n_lanes > I32_MAX:
        raise ValueError(f"{what}: empty CSR/bitmap/payload, block < 1 or "
                         f"edge ids past int32")


def _launcher(name):
    fn = getattr(build.library("bottomup"), f"{name}_launch")
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        head = [i32, i32, p, i32, p, p, p, i64, p, i64, i32]
        fn.argtypes = head + ([p, p, p, p] if name == "bottomup_chunk"
                              else [p, i32, p, p, p, p, p])
        fn.restype = ctypes.c_int
    return fn


def bottomup_chunk(start: int, n_lanes: int, cumul, total, row_off,
                   col_idx, words, *, block: int):
    """One chunk of the parent search over edge ids start ..
    start + n_lanes - 1 of the masked-degree workload.

    cumul: (nrl + 1,) int32 exclusive cumsum of the row degrees with
    visited rows zeroed; total: () int32 live edge count (read on the
    device); row_off / col_idx: the block's CSR; words: the row-gathered
    frontier bitmap, R blocks of ceil(block / 32) int32 words.  CUDA tensors
    launch the kernel (counted in `bottomup_chunk.launches`); CPU tensors
    run the plain version.  The inputs are checked on every device."""
    _check("bottomup_chunk", start, n_lanes, block, cumul=cumul, total=total,
           row_off=row_off, col_idx=col_idx, words=words)
    if not launches_kernel(cumul, "bottomup_chunk"):
        return plain_bottomup_chunk(start, n_lanes, cumul, total, row_off,
                                    col_idx, words, block=block)
    dev = cumul.device
    r = torch.empty(n_lanes, dtype=torch.int32, device=dev)
    c = torch.empty(n_lanes, dtype=torch.int32, device=dev)
    hit = torch.empty(n_lanes, dtype=torch.bool, device=dev)
    if n_lanes == 0:
        return r, c, hit
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _launcher("bottomup_chunk")(
            start, n_lanes, cumul.data_ptr(), row_off.shape[0] - 1,
            total.data_ptr(), row_off.data_ptr(), col_idx.data_ptr(),
            col_idx.shape[0], words.data_ptr(), words.shape[0], block,
            r.data_ptr(), c.data_ptr(), hit.data_ptr(), stream)
    build.check(rc, "bottomup_chunk")
    bottomup_chunk.launches += 1
    return r, c, hit


bottomup_chunk.launches = 0


def bottomup_chunk_values(start: int, n_lanes: int, cumul, total, row_off,
                          col_idx, words, dense_pay, *, block: int):
    """`bottomup_chunk` pulling a value: dense_pay is the frontier payload
    as a dense (n_cols_local,) int32 channel.  Returns (r, pay, addr, hit)
    -- pay = dense_pay[c], addr the clipped CSR address (for per-edge
    values).  CUDA tensors launch the kernel (counted in
    `bottomup_chunk_values.launches`); CPU tensors run the plain version.
    The inputs are checked on every device."""
    _check("bottomup_chunk_values", start, n_lanes, block, cumul=cumul,
           total=total, row_off=row_off, col_idx=col_idx, words=words,
           dense_pay=dense_pay)
    if not launches_kernel(cumul, "bottomup_chunk_values"):
        return plain_bottomup_chunk_values(start, n_lanes, cumul, total,
                                           row_off, col_idx, words,
                                           dense_pay, block=block)
    dev = cumul.device
    out = [torch.empty(n_lanes, dtype=torch.int32, device=dev)
           for _ in range(3)] + [torch.empty(n_lanes, dtype=torch.bool,
                                             device=dev)]
    if n_lanes == 0:
        return tuple(out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _launcher("bottomup_chunk_values")(
            start, n_lanes, cumul.data_ptr(), row_off.shape[0] - 1,
            total.data_ptr(), row_off.data_ptr(), col_idx.data_ptr(),
            col_idx.shape[0], words.data_ptr(), words.shape[0], block,
            dense_pay.data_ptr(), dense_pay.shape[0],
            *(o.data_ptr() for o in out), stream)
    build.check(rc, "bottomup_chunk_values")
    bottomup_chunk_values.launches += 1
    return tuple(out)


bottomup_chunk_values.launches = 0
