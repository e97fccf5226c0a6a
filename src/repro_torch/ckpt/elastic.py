"""Elastic re-sharding: restore a checkpoint onto a DIFFERENT grid, the port
of `repro/ckpt/elastic.py`.

Checkpoints hold GLOBAL arrays, so elasticity = re-laying each leaf out for
the new grid.  The JAX package places each leaf with the new mesh's
NamedSharding; the port has no mesh -- the grid lives in the leading
(R, C) dims of tensors on one device -- so placement is a copy to that
device.  For the BFS, the graph partition itself is a pure function of
(edge list, R, C), so a shrink re-partitions and resumes.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def reshard_state(tree, device):
    """Place a host nested dict (or list / tuple) of numpy arrays as tensors
    on `device`; the (R, C, ...) layout of each leaf is already the target
    grid's."""
    if isinstance(tree, dict):
        return {k: reshard_state(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(reshard_state(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def shrink_grid(R: int, C: int, failed: int):
    """Pick the largest valid 2D grid after losing `failed` devices
    (prefers keeping the ORIGINAL grid's aspect ratio; the BFS re-partitions
    from the edge list).

    Maximality first: among all (r, c) with r*c <= R*C - failed, the largest
    device count wins.  Ties break by aspect-ratio distance to the original
    grid, |log(r/c) - log(R/C)| -- so shrinking a wide 2x4 prefers 2x3 over
    the squarer 3x2, and a square 4x4 losing one device picks 3x5/5x3 (the
    two are equidistant; the lower row count wins deterministically).
    """
    total = R * C - failed
    if total < 1:
        raise ValueError(f"no devices left: {R}x{C} minus {failed}")
    aspect = math.log(R / C)
    best = None
    for r in range(1, total + 1):
        c = total // r
        score = (r * c, -abs(math.log(r / c) - aspect))
        if best is None or score > best[0]:
            best = (score, (r, c))
    return best[1]
