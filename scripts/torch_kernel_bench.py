#!/usr/bin/env python3
"""Kernel microbenches of the PyTorch port on an NVIDIA GPU: the stage ops
and the fused local expand, each beside its plain torch version.

    python3 scripts/torch_kernel_bench.py [--device cuda] [--out FILE.json]

Rows (name, us_per_call, derived), the columns of the JAX package's
`benchmarks/kernel_bench.py`, at its shapes:

  binsearch_map  at (F, E) = (1024, 2^15) and (8192, 2^18): the CUDA kernel
                 (B10), its plain version, and torch.searchsorted alone;
  visited_filter on 2^15 lanes, tile 256, over 2^16 rows: the CUDA kernel
                 (B11) and its plain version;
  local_expand   on a full frontier of n = 2^12 vertices: path="kernel"
                 (through B1) and path="reference".

`derived` is each row's parity: "parity_ok" when the kernel equals its
plain version on every lane (and, for the stage ops, the oracles of
`repro_torch.kernels.ref` on the valid lanes); any difference raises.
Times are CUDA events around repeated calls after a warm-up.  Without a
CUDA device the script exits non-zero; `check(device)` runs the parity
part alone, on any device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import expand as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels import stages as S  # noqa: E402

BINSEARCH_SHAPES = ((1024, 1 << 15), (8192, 1 << 18))
FILTER_LANES, FILTER_TILE, FILTER_ROWS = 1 << 15, 256, 1 << 16
EXPAND_N, EXPAND_CHUNK = 1 << 12, 4096
OUT_FIELDS = ("verts", "parents", "count", "visited", "edges_scanned")


def cases(device):
    """The bench's inputs on `device`, made from one numpy seed."""
    rng = np.random.default_rng(0)
    out = {"binsearch_map": []}
    for f_sz, e in BINSEARCH_SHAPES:
        deg = rng.integers(0, 64, size=f_sz).astype(np.int32)
        cumul = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
        cumul = torch.from_numpy(cumul).to(device)
        out["binsearch_map"].append(
            (f_sz, e, cumul, S.clip_cumul(cumul, f_sz),
             torch.arange(e, dtype=torch.int32, device=device)))
    v = rng.integers(0, FILTER_ROWS, size=FILTER_LANES).astype(np.int32)
    valid = rng.random(FILTER_LANES) < 0.8
    words = rng.integers(0, 2**32, size=FILTER_ROWS // 32,
                         dtype=np.uint64).astype(np.uint32).view(np.int32)
    out["visited_filter"] = tuple(torch.from_numpy(x).to(device)
                                  for x in (v, valid, words))
    n = EXPAND_N
    fdeg = rng.integers(0, 16, size=n).astype(np.int32)
    col_off = np.concatenate([[0], np.cumsum(fdeg)]).astype(np.int32)
    row_idx = rng.integers(0, n, size=int(fdeg.sum())).astype(np.int32)
    out["local_expand"] = (
        (torch.arange(n, dtype=torch.int32, device=device), n),
        (torch.from_numpy(col_off).to(device),
         torch.from_numpy(row_idx).to(device)),
        torch.zeros(n, dtype=torch.bool, device=device))
    return out


def _equal(what, a, b) -> None:
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: the outputs differ")


def _check_binsearch(f_sz, e, cumul, cc, gids):
    k = S.binsearch_map(cc, gids, tile=512)
    _equal(f"binsearch_map F={f_sz} E={e} against its plain version", k,
           S.map_workload(gids, cc))
    ok = gids < cumul[-1]
    _equal(f"binsearch_map F={f_sz} E={e} against the oracle", k[ok],
           R.binsearch_map_ref(cumul, gids)[ok])


def _check_filter(v, valid, words):
    won = S.visited_filter(v, valid, words, tile=FILTER_TILE)
    _equal("visited_filter against its plain version", won,
           S.filter_tile(v, valid, words, FILTER_TILE))
    for a in range(0, v.shape[0], FILTER_TILE):
        s = slice(a, a + FILTER_TILE)
        _equal(f"visited_filter tile at {a} against the oracle", won[s],
               R.visited_filter_ref(v[s], valid[s], words))


def _local_expand(args, path):
    return K.local_expand(*args, path=path, edge_chunk=EXPAND_CHUNK)


def _check_expand(args, path):
    a, b = _local_expand(args, path), _local_expand(args, "reference")
    for f in OUT_FIELDS:
        _equal(f"local_expand {path} against reference: {f}", getattr(a, f),
               getattr(b, f))


def check(device) -> None:
    """Every case's parity on `device` (on the CPU the ops run their plain
    versions, so this holds the bench's inputs to the oracles)."""
    c = cases(device)
    for case in c["binsearch_map"]:
        _check_binsearch(*case)
    _check_filter(*c["visited_filter"])
    _check_expand(c["local_expand"],
                  "kernel" if torch.device(device).type == "cuda" else "auto")


def cuda_us(fn, reps: int = 20) -> float:
    """Mean device time of fn() in microseconds, CUDA events around `reps`
    calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def run(device="cuda") -> list:
    """The bench rows on a CUDA device; raises elsewhere."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"torch_kernel_bench times the CUDA kernels and "
                           f"needs a CUDA device, got {device}")
    c = cases(device)
    rows = [("name", "us_per_call", "derived")]
    for f_sz, e, cumul, cc, gids in c["binsearch_map"]:
        _check_binsearch(f_sz, e, cumul, cc, gids)
        tag = f"F{f_sz}_E{e}"
        rows += [
            (f"binsearch_map_{tag}",
             cuda_us(lambda: S.binsearch_map(cc, gids)), "parity_ok"),
            (f"binsearch_map_plain_{tag}",
             cuda_us(lambda: S.map_workload(gids, cc)), "parity_ok"),
            (f"torch_searchsorted_{tag}",
             cuda_us(lambda: torch.searchsorted(cc, gids, right=True,
                                                out_int32=True)),
             "library call, without the -1")]
    v, valid, words = c["visited_filter"]
    _check_filter(v, valid, words)
    tag = f"tile{FILTER_TILE}_E{FILTER_LANES}_rows{FILTER_ROWS}"
    rows += [
        (f"visited_filter_{tag}",
         cuda_us(lambda: S.visited_filter(v, valid, words,
                                          tile=FILTER_TILE)), "parity_ok"),
        (f"visited_filter_plain_{tag}",
         cuda_us(lambda: S.filter_tile(v, valid, words, FILTER_TILE)),
         "parity_ok")]
    args = c["local_expand"]
    _check_expand(args, "kernel")
    for path in ("kernel", "reference"):
        rows.append((f"local_expand_{path}_n{EXPAND_N}",
                     cuda_us(lambda: _local_expand(args, path), reps=5),
                     "parity_ok"))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args()
    rows = run(args.device)
    print(f"device: {torch.cuda.get_device_name(torch.device(args.device))}")
    for name, us, derived in rows[1:]:
        print(f"{name:48s} {us:12.2f} us  {derived}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
