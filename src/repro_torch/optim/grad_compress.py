"""Gradient compression for cross-pod data parallelism, the port of
`repro/optim/grad_compress.py`.

Two codecs, composable with a train step's gradient sync:
  * top-k sparsification with ERROR FEEDBACK (a tree of residuals; Stich et
    al. / Deep Gradient Compression);
  * int8 range quantisation (per-tensor scale) for the dense remainder.

Trees are nested dicts and lists of tensors, leaves in the JAX package's
order (`optim.adamw.tree_leaves`).  `torch.topk` may order tied magnitudes
otherwise than `jax.lax.top_k`: the kept set, the densified gradient and
the error feedback are the same whenever no tie straddles the k-th place.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map


def topk_compress_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _topk_one(g, err, frac):
    g = g.to(torch.float32) + err
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    _, idx = torch.topk(torch.abs(flat), k)
    kept = flat[idx]
    sparse_flat = torch.zeros_like(flat).index_put_((idx,), kept)
    new_err = flat - sparse_flat
    return (idx.to(torch.int32), kept), new_err.reshape(g.shape)


def topk_compress(grads, err_state, *, frac=0.01):
    """Returns (compressed list of (idx, val) in leaf order, new
    error-feedback tree, densify fn)."""
    results = [_topk_one(g, e, frac) for g, e in
               zip(tree_leaves(grads), tree_leaves(err_state))]
    comp = [r[0] for r in results]
    errs = iter(r[1] for r in results)
    err = tree_map(lambda _: next(errs), grads)

    def densify(comp_list, like):
        parts = iter(comp_list)

        def dense(p):
            idx, val = next(parts)
            out = torch.zeros(p.numel(), dtype=torch.float32,
                              device=val.device)
            return out.index_put_((idx.long(),), val).reshape(p.shape)
        return tree_map(dense, like)

    return comp, err, densify


def int8_compress(g):
    """Per-tensor symmetric int8: returns (q int8, scale f32)."""
    g = g.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q, scale):
    return q.to(torch.float32) * scale
