#!/usr/bin/env python3
"""The port on a CUDA card against the port on the CPU: one R-MAT graph,
made with numpy from a seed, planned on both devices, every output field of
every query compared exactly.

    python3 scripts/torch_card_vs_cpu.py [--scale 12] [--seed 0] [--quick]

The CPU tests hold the CPU path to the JAX package, so this ties the card
to it too: the card's `index_put_` with repeated indices,
`scatter_reduce_`, CUDA sorts and kernels against the CPU's ops.  Queries,
each on a 2x2 grid, a scalar root and a batch of two:
  * BFS under every direction mode (False, True, "bottomup") x fold codec
    (list, bitmap, delta) x dedup (scatter, sort);
  * connected components, SSSP (scalar and batched) and multi-source BFS at
    the programs' default codec, top-down and direction-optimised.
--quick runs five of the BFS configurations, one per codec, direction mode
and dedup at least, and the value programs once each way.  It raises
(exits non-zero) at the first difference, and without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys
import time

import numpy as np

BFS_MODES = (False, True, "bottomup")
CODECS = ("list", "bitmap", "delta")
DEDUPS = ("scatter", "sort")
QUICK_BFS = ((False, "list", "scatter"), (False, "bitmap", "sort"),
             (True, "bitmap", "scatter"), (True, "delta", "sort"),
             ("bottomup", "list", "sort"))


def rmat_numpy(scale: int, edge_factor: int, seed: int):
    """Symmetrised R-MAT edges, (A, B, C) = (0.57, 0.19, 0.19): a (2, E)
    int32 array, E = 2 * edge_factor * 2^scale, and (E,) uint8 weights in
    1..255."""
    rng = np.random.default_rng(seed)
    m = edge_factor << scale
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        r = rng.random(m)
        src |= (r >= 0.76).astype(np.int64) << bit          # quadrants C, D
        dst |= (((r >= 0.57) & (r < 0.76)) | (r >= 0.95)) \
            .astype(np.int64) << bit                         # quadrants B, D
    edges = np.stack([np.concatenate([src, dst]),
                      np.concatenate([dst, src])]).astype(np.int32)
    weights = rng.integers(1, 256, size=edges.shape[1]).astype(np.uint8)
    return edges, weights


def _same(a, b) -> list:
    """Names of the fields on which two outputs differ."""
    import torch
    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            if not torch.equal(x.cpu(), y.cpu()):
                bad.append(f.name)
        elif x != y:
            bad.append(f.name)
    return bad


def run(dev, *, scale: int = 12, seed: int = 0, quick: bool = False,
        log=print) -> list:
    """Every query on `dev` and on the CPU, compared field by field.
    Returns [(query, seconds on dev, seconds on the CPU)]; raises
    AssertionError naming the query and the fields that differ, or when no
    direction-optimised query ran a bottom-up level."""
    import torch

    from repro_torch.api import BFSConfig, DistGraph

    edges, weights = rmat_numpy(scale, 16, seed)
    n = 1 << scale
    deg = np.bincount(edges[0], minlength=n)
    roots = np.random.default_rng(seed).choice(np.flatnonzero(deg > 0), 2,
                                               replace=False).tolist()
    grid = (2, 2)
    graphs = {d: DistGraph.from_edges(edges, BFSConfig(grid=grid), n=n,
                                      weights=weights, device=d)
              for d in (dev, "cpu")}
    rows = []
    bottomup = []          # the queries that ran a bottom-up level

    def check(what, cfg, call):
        secs, outs = [], []
        for d in (dev, "cpu"):
            sess = graphs[d].session(cfg)
            sync = torch.device(d).type == "cuda"
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(call(sess))
            if sync:
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        bad = _same(*outs)
        if bad:
            raise AssertionError(f"{what}: the card differs from the CPU on "
                                 f"{bad}")
        rows.append((what, secs[0], secs[1]))
        dirs = outs[1].directions
        if dirs is not None and bool((dirs == 1).any()):
            bottomup.append(what)
        log(f"{what}: equal on every field; card {secs[0]:.3f} s, CPU "
            f"{secs[1]:.3f} s")

    bfs = QUICK_BFS if quick else itertools.product(BFS_MODES, CODECS,
                                                    DEDUPS)
    for direction, codec, dedup in bfs:
        cfg = BFSConfig(grid=grid, direction=direction, fold_codec=codec,
                        dedup=dedup)
        tag = f"bfs direction={direction} codec={codec} dedup={dedup}"
        check(f"{tag} root {roots[0]}", cfg, lambda s: s.bfs(roots[0]))
        check(f"{tag} roots {roots}", cfg, lambda s: s.bfs(roots))
    for direction in (False, True):
        cfg = BFSConfig(grid=grid, direction=direction)
        tag = f"direction={direction}"
        check(f"connected_components {tag}", cfg,
              lambda s: s.connected_components())
        check(f"sssp root {roots[0]} {tag}", cfg,
              lambda s: s.sssp(roots[0]))
        check(f"sssp roots {roots} {tag}", cfg, lambda s: s.sssp(roots))
        check(f"multi_bfs sources {roots} {tag}", cfg,
              lambda s: s.multi_bfs(roots))
    if not any("direction=True" in q for q in bottomup):
        raise AssertionError("no direction-optimised query ran a bottom-up "
                             "level")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False")
        return 1
    t0 = time.perf_counter()
    rows = run(torch.device("cuda"), scale=args.scale, seed=args.seed,
               quick=args.quick)
    print(f"{len(rows)} queries equal on the card and the CPU in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
