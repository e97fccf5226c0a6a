"""The fused bottom-up parent search over one chunk of consecutive edge ids
(DESIGN.md sec. 11), the port of `repro/kernels/bottomup.py:
bottomup_chunk`.

  stage 1  workload map    r = max{l : cc[l] <= gid} over the masked-degree
                           cumsum clipped BY VALUE (cc = cumul where
                           cumul < total, else I32_MAX)
  stage 2  neighbour gather c = col_idx[row_off[r] + gid - cc[r]] (CSR)
  stage 3  frontier test   blocked-bitmap membership of c
                           (`core.frontier.test_bit_blocks` addressing)

`bottomup_chunk` launches the CUDA kernel `csrc/bottomup.cu` for CUDA
tensors and runs `plain_bottomup_chunk`, the same formulas in torch, for CPU
tensors.  Both equal the Pallas kernel lane for lane, masked lanes included.
On masked lanes (gid >= total) the JAX reference scan
(`core.frontier.reference_bottomup_chunk`, `searchsorted` on the unclipped
cumsum) gives another r; only `hit` lanes reach the search's result, where
all three agree.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.select import launches_kernel

I32_MAX = 2**31 - 1


def _wrap_i32(x64):
    """int64 -> int32 with the two's-complement wrap of JAX's int32."""
    return ((x64 + 2**31) % 2**32 - 2**31).to(torch.int32)


def plain_bottomup_chunk(start: int, n_lanes: int, cumul, total, row_off,
                         col_idx, words, *, block: int):
    """The kernel's formulas in plain torch, on any device.

    Returns (r, c, hit): (n_lanes,) int32 candidate local rows, int32
    neighbour local cols (masked lanes 0), bool frontier membership."""
    dev = cumul.device
    nrl = row_off.shape[0] - 1
    nnz_cap = col_idx.shape[0]
    gid = start + torch.arange(n_lanes, dtype=torch.int32, device=dev)
    cc = torch.where(cumul < total, cumul, I32_MAX).to(torch.int32)
    r = torch.searchsorted(cc, gid, right=True, out_int32=True) - 1
    r = r.clamp(0, nrl - 1)
    addr = _wrap_i32(row_off[r].long() + gid.long() - cc[r].long())
    valid = gid < total
    c = torch.where(valid, col_idx[addr.clamp(0, nnz_cap - 1)], 0)
    c = c.to(torch.int32)
    W = (block + 31) // 32
    off = c % block
    w = ((c // block) * W + (off >> 5)).clamp(0, words.shape[0] - 1)
    hit = valid & (((words[w] >> (off & 31)) & 1) != 0)
    return r, c, hit


def _launcher():
    fn = build.library("bottomup").bottomup_chunk_launch
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i32, i32, p, i32, p, p, p, i64, p, i64, i32, p, p, p,
                       p]
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
    dev = cumul.device
    tensors = dict(cumul=cumul, total=total, row_off=row_off,
                   col_idx=col_idx, words=words)
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"bottomup_chunk: {name} must be a contiguous "
                             f"int32 tensor on {dev}, got {t.dtype} on "
                             f"{t.device}")
    nrl = row_off.shape[0] - 1
    if (cumul.shape != (nrl + 1,) or total.numel() != 1
            or col_idx.dim() != 1 or words.dim() != 1):
        raise ValueError(
            f"bottomup_chunk: shapes cumul {tuple(cumul.shape)}, total "
            f"{tuple(total.shape)}, row_off {tuple(row_off.shape)}, col_idx "
            f"{tuple(col_idx.shape)}, words {tuple(words.shape)}")
    if nrl < 1 or col_idx.shape[0] < 1 or words.shape[0] < 1 or block < 1 \
            or start < 0 or start + n_lanes > I32_MAX:
        raise ValueError("bottomup_chunk: empty CSR/bitmap, block < 1 or "
                         "edge ids past int32")
    if not launches_kernel(cumul, "bottomup_chunk"):
        return plain_bottomup_chunk(start, n_lanes, cumul, total, row_off,
                                    col_idx, words, block=block)
    r = torch.empty(n_lanes, dtype=torch.int32, device=dev)
    c = torch.empty(n_lanes, dtype=torch.int32, device=dev)
    hit = torch.empty(n_lanes, dtype=torch.bool, device=dev)
    if n_lanes == 0:
        return r, c, hit
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(start, n_lanes, cumul.data_ptr(), nrl, total.data_ptr(),
                row_off.data_ptr(), col_idx.data_ptr(), col_idx.shape[0],
                words.data_ptr(), words.shape[0], block, r.data_ptr(),
                c.data_ptr(), hit.data_ptr(), stream)
    build.check(rc, "bottomup_chunk")
    bottomup_chunk.launches += 1
    return r, c, hit


bottomup_chunk.launches = 0

