"""Expert-parallel MoE layer (kimi-k2, qwen2-moe), the port of
`repro/models/moe.py`.

The dispatch is the paper's fold exchange applied to tokens instead of
vertices: bucket each (token, expert) copy by OWNER shard
(`repro_torch.core.frontier.bucket_append`, the stable sort-based
compaction of the BFS), all_to_all the buckets along the expert axis, run
the local grouped GEMMs, and all_to_all back.

Capacity-based (GShard-style): copies beyond a bucket's capacity are
dropped and contribute zero output.  The router is fp32; the aux
load-balance loss follows Switch (E * sum(f_e * p_e)).

Where the JAX package runs one `_moe_local` body a device under
`shard_map`, the port runs every device of a `StackedMesh` at once: each
per-device tensor carries a leading device dim (the mesh's devices in
row-major order), and an all_to_all over the expert axis is a swap of that
axis's mesh dim with the destination dim -- the stacked grid's
`col_all_to_all` rule.  The FSDP all_gather of the expert weights is the
identity there (a stacked device holds its experts whole), and the aux
loss is the mean over the devices, as JAX's `pmean`.

Across a process group (a `multihost.ProcessMesh`) each rank runs that
body for the processors of its block, and every all_to_all of the
dispatch is one `axis_all_to_all` in the expert axis's sub-group (int8
values and their scales under `quant_dispatch`); with `fsdp_axis` each
processor holds its experts' d_model slice and `axis_all_gather`s them
over that axis.  Every rank passes the whole x and the whole weights and
gets the whole y and the group's mean aux, as `make_spmm2d` does.
Gradients flow as under JAX's `shard_map`: an all_to_all's backward is
the same all_to_all of the gradient (it is its own inverse), the FSDP
gather's is a reduce-scatter (an all_to_all, then the sum), the
replicated inputs' is a float32 all-reduce over the group, and the
gathered y's takes the rank's own rows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.frontier import bucket_append
from repro_torch.dist import multihost as MH
from repro_torch.dist import wire
from repro_torch.dist.compat import StackedMesh
from repro_torch.sparse.segment import at_add


@dataclasses.dataclass(frozen=True)
class MoEShard:
    """How to run the MoE: tokens sharded over token_axes, experts over
    expert_axis (EP), optional FSDP of expert weights over fsdp_axis, and
    optional int8 dispatch quantisation.  None mesh = reference path."""
    mesh: object = None
    token_axes: tuple = ()
    expert_axis: Optional[str] = None
    fsdp_axis: Optional[str] = None
    quant_dispatch: bool = False

    @property
    def ep(self) -> int:
        if self.mesh is None or self.expert_axis is None:
            return 1
        return dict(zip(self.mesh.axis_names,
                        self.mesh.shape))[self.expert_axis]


def _route(x, router_w, top_k, n_real=None):
    """x (..., N, d) -> (top indices int32, normalised top weights, aux);
    leading dims route independently (aux has their shape).  Ties take the
    lower expert first, as `jax.lax.top_k` does (a stable descending
    sort); phantom experts (>= n_real) get -1e30 logits and no copy."""
    logits = x.to(torch.float32) @ router_w
    E = router_w.shape[-1]
    if n_real is not None and n_real < E:
        real = torch.arange(E, device=logits.device) < n_real
        logits = torch.where(real, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :top_k], topi[..., :top_k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # Switch aux loss: fraction routed vs mean prob, per expert
    lead = topi.shape[:-2]
    flat = topi.reshape(lead + (-1,))
    f = torch.zeros(lead + (E,), dtype=torch.float32, device=x.device)
    f = f.scatter_add(-1, flat, torch.ones(flat.shape, dtype=torch.float32,
                                           device=x.device))
    f = f / max(flat.shape[-1], 1)
    aux = E * torch.sum(f * probs.mean(-2), dim=-1)
    return topi.to(torch.int32), topv, aux


def _grouped_ffn(buf, mask, w1, w3, w2):
    """buf: (..., E_loc, cap_e, d); SwiGLU per expert."""
    h = torch.nn.functional.silu(buf @ w1) * (buf @ w3)
    y = h @ w2
    return torch.where(mask[..., None], y, 0)


def _buckets(tgt, take, n_buckets: int, cap: int):
    """Per device, `bucket_append` of the positions 0..M-1 into n_buckets
    buckets of cap slots by target: (D, M) targets and take mask ->
    (D, n_buckets, cap) int32 positions, -1 padded.  One stable sort over
    device-major keys is each device's own stable sort."""
    D, M = tgt.shape
    dev = torch.arange(D, dtype=torch.int32, device=tgt.device)[:, None]
    key = (tgt.to(torch.int32) + dev * n_buckets).reshape(-1)
    pos = torch.arange(M, dtype=torch.int32,
                       device=tgt.device).expand(D, M).reshape(-1)
    dst = torch.full((D * n_buckets, cap), -1, dtype=torch.int32,
                     device=tgt.device)
    dst, _ = bucket_append(dst, torch.zeros(D * n_buckets, dtype=torch.int32,
                                            device=tgt.device),
                           pos, key, take.reshape(-1), D * n_buckets)
    return dst.reshape(D, n_buckets, cap)


def _rows(table, idx):
    """Per device, table[d][idx[d]]: (D, M, ...) and (D, ...) indices in
    [0, M) -> (D, ..., table's trailing dims)."""
    D, M = table.shape[:2]
    off = (torch.arange(D, device=idx.device) * M).reshape(
        (D,) + (1,) * (idx.dim() - 1))
    return table.reshape((D * M,) + table.shape[2:])[idx.long() + off]


def _all_to_all(t, shape: tuple, axis: int):
    """JAX's `all_to_all(t, expert_axis, 0, 0)` on stacked devices: t (D,
    ep, ...) with dim 1 the destination along mesh dim `axis`; device c
    receives in row p what device c' (c'_axis = p) sent to c_axis."""
    t = wire.mark(t, "all-to-all", t.nbytes, shape[axis])
    rest = t.shape[2:]
    m = len(shape)
    out = t.reshape(tuple(shape) + (shape[axis],) + rest).transpose(axis, m)
    return out.reshape((t.shape[0], shape[axis]) + rest)


def _per_device(w, shape: tuple, axis: int):
    """(E, ...) expert weights -> (D, E_loc, ...): each device's experts,
    the block of its coordinate along the expert axis."""
    ep = shape[axis]
    w = w.reshape((ep, w.shape[0] // ep) + w.shape[1:])
    view = (1,) * axis + (ep,) + (1,) * (len(shape) - axis - 1)
    w = w.reshape(view + w.shape[1:]).expand(tuple(shape) + w.shape[1:])
    return w.reshape((-1,) + w.shape[len(shape):])


def _quantised(t):
    """The int8 codec of the dispatch: (int8 values, per-copy scale)."""
    sc = torch.amax(torch.abs(t), dim=-1, keepdim=True) / 127.0
    q = torch.round(t / torch.clamp(sc, min=1e-9)).to(torch.int8)
    return q, sc


def _exchange(t, a2a, quant: bool, dtype):
    """One all_to_all of the dispatch, int8-quantised when asked."""
    if not quant:
        return a2a(t)
    q, sc = _quantised(t)
    q, sc = a2a(q), a2a(sc)
    return q.to(dtype) * sc.to(dtype)


def _moe_devices(x, router_w, w1, w3, w2, *, top_k: int, ep: int, a2a,
                 capacity_factor: float, cap_e_mult: int = 4,
                 n_real=None, quant_dispatch: bool = False):
    """Every device's `_moe_local` at once: x (D, N, d) per-device tokens,
    w1 / w3 / w2 (D, E_loc, ...) each device's experts, ep the size of the
    expert axis and a2a(t) the all_to_all over it of a (D, ep, ...)
    tensor.  Returns ((D, N, d), (D,) aux)."""
    D, N, d = x.shape
    E_loc = w1.shape[1]
    topi, topv, aux = _route(x, router_w, top_k, n_real)

    copies = N * top_k
    tok = torch.arange(N, dtype=torch.int32,
                       device=x.device).repeat_interleave(top_k)
    e_flat = topi.reshape(D, copies)
    w_flat = topv.reshape(D, copies).to(x.dtype)

    cap_s = max(8, int(math.ceil(copies / ep * capacity_factor)))
    dst = _buckets(e_flat // E_loc, torch.ones_like(e_flat, dtype=torch.bool),
                   ep, cap_s)
    s_valid = dst >= 0
    dsafe = torch.where(s_valid, dst, 0)
    send_tok = tok[dsafe.long()]
    send_x = torch.where(s_valid[..., None], _rows(x, send_tok), 0)
    send_e = torch.where(s_valid, _rows(e_flat, dsafe) % E_loc, 0)

    if ep > 1:
        recv_x = _exchange(send_x, a2a, quant_dispatch, x.dtype)
        recv_e = a2a(send_e)
        recv_v = a2a(s_valid)
    else:
        recv_x, recv_e, recv_v = send_x, send_e, s_valid

    # group received copies by local expert
    flat = ep * cap_s
    cap_e = min(flat, max(8, int(math.ceil(flat / E_loc)) * cap_e_mult))
    gidx = _buckets(recv_e.reshape(D, flat), recv_v.reshape(D, flat), E_loc,
                    cap_e)
    g_valid = gidx >= 0
    gsafe = torch.where(g_valid, gidx, 0)
    buf = torch.where(g_valid[..., None],
                      _rows(recv_x.reshape(D, flat, d), gsafe), 0)

    y = _grouped_ffn(buf, g_valid, w1, w3, w2)

    dev = torch.arange(D, device=x.device).reshape(D, 1, 1)
    slot = torch.where(g_valid, gidx.long() + dev * flat, D * flat)
    y_recv = at_add(D * flat, slot.reshape(-1),
                    y.reshape(-1, d)).to(x.dtype).reshape(D, ep, cap_s, d)

    y_send = _exchange(y_recv, a2a, quant_dispatch, x.dtype) \
        if ep > 1 else y_recv

    contrib = torch.where(s_valid[..., None],
                          y_send * _rows(w_flat, dsafe)[..., None], 0)
    row = torch.where(s_valid, send_tok.long() + dev * N, D * N)
    out = at_add(D * N, row.reshape(-1), contrib.reshape(-1, d))
    return out.to(x.dtype).reshape(D, N, d), aux


def _moe_local(x, router_w, w1, w3, w2, *, top_k: int,
               capacity_factor: float, cap_e_mult: int = 4, n_real=None):
    """Device-local body at EP = 1 (the reference path): x (N, d) ->
    ((N, d), aux).  JAX's body also runs at ep > 1 under `shard_map`; here
    `moe_apply` runs that on every device of a `StackedMesh` at once, or
    on every processor of a rank's block of a `ProcessMesh`."""
    y, aux = _moe_devices(x[None], router_w, w1[None], w3[None], w2[None],
                          top_k=top_k, ep=1, a2a=None,
                          capacity_factor=capacity_factor,
                          cap_e_mult=cap_e_mult, n_real=n_real)
    return y[0], aux[0]


def _token_layout(mesh: MoEShard):
    """(mesh shape, expert dim, tokens' shard count, each device's token
    shard, each shard's first device): dim 0 sharded over token_axes
    jointly, the first named axis major, as `P(token_axes)` shards it."""
    names, shape = tuple(mesh.mesh.axis_names), tuple(mesh.mesh.shape)
    coords = torch.cartesian_prod(*(torch.arange(s) for s in shape)) \
        .reshape(-1, len(shape))
    shard = torch.zeros(coords.shape[0], dtype=torch.long)
    n_shards = 1
    for a in mesh.token_axes:
        i = names.index(a)
        shard = shard * shape[i] + coords[:, i]
        n_shards *= shape[i]
    first = torch.stack([torch.nonzero(shard == k)[0, 0]
                         for k in range(n_shards)])
    return shape, names.index(mesh.expert_axis), n_shards, shard, first


class _AxisAllToAll(torch.autograd.Function):
    """`axis_all_to_all` of a float tensor; the gradient goes back through
    the same all_to_all (a permutation that is its own inverse)."""

    @staticmethod
    def forward(ctx, t, pm, axis):
        ctx.pm, ctx.axis = pm, axis
        return MH.axis_all_to_all(t, pm, axis)

    @staticmethod
    def backward(ctx, g):
        return MH.axis_all_to_all(g.contiguous(), ctx.pm, ctx.axis), None, \
            None


class _AxisAllGather(torch.autograd.Function):
    """`axis_all_gather`; its gradient is the reduce-scatter: each
    gathered piece's gradient goes back to its owner (an all_to_all) and
    the owner sums them."""

    @staticmethod
    def forward(ctx, t, pm, axis):
        ctx.pm, ctx.axis = pm, axis
        return MH.axis_all_gather(t, pm, axis)

    @staticmethod
    def backward(ctx, g):
        back = MH.axis_all_to_all(g.contiguous(), ctx.pm, ctx.axis)
        return back.sum(dim=2), None, None


class _Replicated(torch.autograd.Function):
    """A tensor every rank holds whole, entering the ranks' bodies: the
    identity, whose gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return MH.all_reduce_sum(g.contiguous(), ctx.group), None


class _Gathered(torch.autograd.Function):
    """Every rank's (n, ...) rows stacked in rank order on every rank: the
    ranks' bodies leaving for the whole result.  Every rank goes on with
    the same whole result, so a rank's gradient is its own rows'."""

    @staticmethod
    def forward(ctx, t, pm):
        ctx.rank, ctx.n = pm.rank, t.shape[0]
        g = MH.all_gather(t.contiguous(), pm.group, pm.world)
        return g.reshape((-1,) + tuple(t.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def _enter(t, pm):
    return _Replicated.apply(t, pm.group) if t.requires_grad else t


def _group_weights(w, pm, names, axis: int, fsdp_axis, dim: int):
    """(E, ...) expert weights -> (D_loc, E_loc, ...) for the processors of
    the rank's block: each its expert coordinate's block of experts; with
    `fsdp_axis` each holds the slice of dim `dim` (of a per-device (E_loc,
    ...) weight) at its coordinate along that axis, all_gathered over
    it."""
    ep = pm.shape[axis]
    E_loc = w.shape[0] // ep
    coords = [(i, j) for i in range(pm.i0, pm.i0 + pm.Rl)
              for j in range(pm.j0, pm.j0 + pm.Cl)]
    if fsdp_axis is None:
        return torch.stack([w[c[axis] * E_loc:(c[axis] + 1) * E_loc]
                            for c in coords])
    fa = names.index(fsdp_axis)
    F = pm.shape[fa]
    if w.shape[dim] % F:
        raise ValueError(f"fsdp_axis {fsdp_axis!r} of size {F} does not "
                         f"divide the experts' dim of {w.shape[dim]}")
    piece = w.shape[dim] // F
    own = torch.stack([w[c[axis] * E_loc:(c[axis] + 1) * E_loc].narrow(
        dim, c[fa] * piece, piece) for c in coords])
    own = own.reshape((pm.Rl, pm.Cl) + tuple(own.shape[1:]))
    full = _AxisAllGather.apply(own, pm, fa)   # (Rl, Cl, F, E_loc, ...)
    full = full.movedim(2, 2 + dim)
    shape = list(w.shape)
    shape[0] = E_loc
    return full.reshape([pm.Rl * pm.Cl] + shape)


def _moe_group(x, mp, cfg, mesh: MoEShard, cap_e_mult: int):
    """`moe_apply`'s expert-parallel path over a `ProcessMesh`: this
    rank's processors' bodies, the collectives across the group."""
    pm = mesh.mesh
    names = tuple(pm.axis_names)
    if mesh.fsdp_axis == mesh.expert_axis:
        raise ValueError("fsdp_axis and expert_axis must differ")
    _, axis, n_shards, shard, first = _token_layout(mesh)
    L = pm.Rl * pm.Cl
    mine = shard[pm.rank * L:(pm.rank + 1) * L].to(x.device)
    x = _enter(x, pm)
    N, d = x.shape
    pad = (-N) % n_shards
    if pad:
        x = torch.cat([x, x.new_zeros((pad, d))])
    xs = x.reshape(n_shards, -1, d)[mine]
    router = _enter(mp["router"], pm)
    w1, w3, w2 = (_group_weights(_enter(mp[k], pm), pm, names, axis,
                                 mesh.fsdp_axis, dim)
                  for k, dim in (("w1", 1), ("w3", 1), ("w2", 2)))

    def a2a(t):
        blk = t.reshape((pm.Rl, pm.Cl) + tuple(t.shape[1:]))
        out = _AxisAllToAll.apply(blk, pm, axis) if t.is_floating_point() \
            else MH.axis_all_to_all(blk, pm, axis)
        return out.reshape(t.shape)

    y, aux = _moe_devices(xs, router, w1, w3, w2, top_k=cfg.top_k,
                          ep=pm.shape[axis], a2a=a2a,
                          capacity_factor=cfg.capacity_factor,
                          cap_e_mult=cap_e_mult, n_real=cfg.n_experts,
                          quant_dispatch=mesh.quant_dispatch)
    y = _Gathered.apply(y, pm)
    aux = _Gathered.apply(aux, pm)
    return y[first.to(x.device)].reshape(-1, d)[:N], aux.mean()


def moe_apply(x, mp, cfg, mesh: Optional[MoEShard] = None):
    """x: (N, d) global token activations.  Returns (y (N, d), aux scalar).

    mp holds router/w1/w3/w2; mesh (MoEShard) over a `StackedMesh` or a
    `multihost.ProcessMesh` selects the EP path (tokens padded to a
    multiple of the token shards, every shard with its own capacity, aux
    the devices' mean)."""
    cap_e_mult = getattr(cfg, "cap_e_mult", 4)
    if mesh is None or mesh.mesh is None or mesh.ep == 1:
        return _moe_local(x, mp["router"], mp["w1"], mp["w3"], mp["w2"],
                          top_k=cfg.top_k,
                          capacity_factor=cfg.capacity_factor,
                          cap_e_mult=cap_e_mult, n_real=cfg.n_experts)
    if mesh.fsdp_axis is not None and \
            mesh.fsdp_axis not in mesh.mesh.axis_names:
        raise ValueError(f"fsdp_axis {mesh.fsdp_axis!r} is not an axis of "
                         f"the mesh {mesh.mesh.axis_names}")
    if not isinstance(mesh.mesh, StackedMesh):
        return _moe_group(x, mp, cfg, mesh, cap_e_mult)
    shape, axis, n_shards, shard, first = _token_layout(mesh)
    N, d = x.shape
    pad = (-N) % n_shards
    if pad:
        x = torch.cat([x, x.new_zeros((pad, d))])
    xs = x.reshape(n_shards, -1, d)[shard.to(x.device)]
    w1, w3, w2 = (_per_device(mp[k], shape, axis) for k in ("w1", "w3", "w2"))
    if mesh.fsdp_axis is not None:     # the gather a real mesh would run
        F = dict(zip(mesh.mesh.axis_names, shape))[mesh.fsdp_axis]
        w1, w3, w2 = (wire.mark(w, "all-gather",
                                w.numel() * w.element_size(), F)
                      for w in (w1, w3, w2))
    y, aux = _moe_devices(xs, mp["router"], w1, w3, w2, top_k=cfg.top_k,
                          ep=shape[axis],
                          a2a=lambda t: _all_to_all(t, shape, axis),
                          capacity_factor=cfg.capacity_factor,
                          cap_e_mult=cap_e_mult, n_real=cfg.n_experts,
                          quant_dispatch=mesh.quant_dispatch)
    return y[first.to(x.device)].reshape(-1, d)[:N], aux.mean()
