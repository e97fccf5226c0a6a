"""Minimal E(3)-equivariant algebra for l_max <= 2, in the CARTESIAN basis,
the port of `repro/models/gnn/e3.py` (plain functions over {"s", "v", "t"}
dicts of tensors).

For l <= 2 the e3nn algebra is exactly expressible with Cartesian tensors,
where every coupling path is a dense contraction and equivariance is
manifest:

  l=0  <-> scalar s
  l=1  <-> vector v (3,)
  l=2  <-> traceless symmetric matrix t (3, 3)

Features: dict {"s": (N, C), "v": (N, C, 3), "t": (N, C, 3, 3)}.
Coupling paths used (a complete generating set for l<=2):
  s*s->s   v.v->s    t:t->s
  s*v->v   v x v->v  t@v->v
  s*t->t   v(x)v->t  sym(t@t)->t  v(x)t-ish via t@v paths
Radial envelopes weight each path per channel (NequIP-style).

`sph` gives Y1 = r_hat and Y2 = r_hat r_hat^T - I/3.  The norm is
sqrt(sum(r * r)), JAX's `linalg.norm` formula, so its gradient at r = 0
is what JAX's is.
"""
from __future__ import annotations

import math

import torch

from repro_torch.sparse.segment import at_add


def _eye(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def traceless_sym(m):
    """Project (..., 3, 3) onto traceless symmetric part (the l=2
    subspace)."""
    s = 0.5 * (m + m.transpose(-1, -2))
    tr = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return s - tr * _eye(m) / 3.0


def sph(r):
    """r: (..., 3) displacement -> (rhat (...,3), Y2 (...,3,3), d (...,))."""
    d = torch.sqrt(torch.sum(r * r, dim=-1))
    rhat = r / torch.clamp(d, min=1e-9)[..., None]
    y2 = rhat[..., :, None] * rhat[..., None, :] - _eye(r) / 3.0
    return rhat, y2, d


def bessel_basis(d, n_rbf: int, cutoff: float):
    """Radial Bessel basis sin(n pi d / rc) / d with polynomial envelope
    (NequIP / DimeNet standard)."""
    dn = torch.clamp(d / cutoff, 1e-6, 1.0)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=d.device)
    rb = torch.sin(math.pi * n * dn[..., None]) / dn[..., None]
    # p=6 polynomial cutoff envelope
    env = 1 - 28 * dn**6 + 48 * dn**7 - 21 * dn**8
    return rb * env[..., None], env


# ----------------------------------------------------------------------------
# tensor-product paths: (features of j) x (edge harmonics), channelwise
# weighted by radial coefficients w[...] of shape (E, C)
# ----------------------------------------------------------------------------

N_PATHS = 10


def edge_tensor_product(feat_j, rhat, y2, w):
    """feat_j: {"s": (E, C), "v": (E, C, 3), "t": (E, C, 3, 3)};
    rhat (E, 3), y2 (E, 3, 3); w (E, C, N_PATHS) radial path weights.
    Returns message dict with the same structure."""
    s, v, t = feat_j["s"], feat_j["v"], feat_j["t"]
    r1 = rhat[:, None, :]                      # (E, 1, 3)
    Y2 = y2[:, None, :, :]                     # (E, 1, 3, 3)

    out_s = (w[..., 0] * s
             + w[..., 1] * torch.einsum("eci,ei->ec", v, rhat)
             + w[..., 2] * torch.einsum("ecij,eij->ec", t, y2))
    tv = torch.matmul(t, rhat[:, None, :, None])[..., 0]    # (E, C, 3)
    out_v = (w[..., 3, None] * s[..., None] * r1
             + w[..., 4, None] * v
             + w[..., 5, None] * torch.linalg.cross(v, r1.expand(v.shape),
                                                    dim=-1)
             + w[..., 6, None] * tv)
    out_t = (w[..., 7, None, None] * s[..., None, None] * Y2
             + w[..., 8, None, None] * t
             + w[..., 9, None, None] * traceless_sym(
                 v[..., :, None] * r1[..., None, :]))
    return {"s": out_s, "v": out_v, "t": out_t}


def self_tensor_product(f, w):
    """Quadratic self-interaction (MACE's A x A): channelwise couplings of a
    feature with itself; w (N, C, 6)."""
    s, v, t = f["s"], f["v"], f["t"]
    out_s = (w[..., 0] * s * s
             + w[..., 1] * torch.einsum("nci,nci->nc", v, v)
             + w[..., 2] * torch.einsum("ncij,ncij->nc", t, t))
    out_v = (w[..., 3, None] * torch.matmul(t, v[..., None])[..., 0])
    out_t = (w[..., 4, None, None] * traceless_sym(
                 v[..., :, None] * v[..., None, :])
             + w[..., 5, None, None] * traceless_sym(torch.matmul(t, t)))
    return {"s": out_s, "v": out_v, "t": out_t}


def linear_mix(f, ws, wv, wt):
    """Per-irrep channel mixing (self-interaction): w*: (C_in, C_out),
    contracted over each irrep's channel axis."""
    v = torch.movedim(torch.tensordot(f["v"], wv, dims=([f["v"].dim() - 2],
                                                        [0])), -1, -2)
    t = torch.movedim(torch.tensordot(f["t"], wt, dims=([f["t"].dim() - 3],
                                                        [0])), -1, -3)
    return {"s": f["s"] @ ws, "v": v, "t": t}


def gate(f, gv, gt):
    """Equivariant gate: scalars -> silu; v/t scaled by sigmoid(gate
    scalars).  gv/gt: (C_s, C) projections from scalar channels."""
    s = torch.nn.functional.silu(f["s"])
    gvx = torch.sigmoid(f["s"] @ gv)
    gtx = torch.sigmoid(f["s"] @ gt)
    return {"s": s, "v": f["v"] * gvx[..., None],
            "t": f["t"] * gtx[..., None, None]}


def add(a, b):
    return {k: a[k] + b[k] for k in a}


def zeros(n, c, dtype=torch.float32, device=None):
    return {"s": torch.zeros((n, c), dtype=dtype, device=device),
            "v": torch.zeros((n, c, 3), dtype=dtype, device=device),
            "t": torch.zeros((n, c, 3, 3), dtype=dtype, device=device)}


def scatter_nodes(msg, dst, n, valid=None):
    """Segment-sum each irrep component onto destination nodes (masked
    edges dropped, as JAX's mode="drop" on index n)."""
    dst = torch.where(valid, dst.long(), n) if valid is not None else dst

    def red(x):
        m = x if valid is None else torch.where(
            valid.reshape((-1,) + (1,) * (x.dim() - 1)), x, 0.0)
        return at_add(n, dst, m)

    return {k: red(x) for k, x in msg.items()}
