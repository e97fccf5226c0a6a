"""Decoder-only LM family: dense (glm4, gemma2, h2o-danube) and MoE
(kimi-k2, qwen2-moe) variants from one implementation, the port of
`repro/models/lm.py`.

`LM` is an `nn.Module` whose parameters are the JAX tree's paths, held
stacked over layers as JAX holds them (`embed`, `ln_f`, `attn.wq` of shape
(L, d, H * dh), `mlp.router`, `mlp.sw1`, ...), so
`convert.load_jax_params` copies a JAX tree in leaf for leaf.  Its methods
are the JAX package's functions: `forward` (logits, aux), `loss` =
`loss_fn`, `decode_step`.  Where JAX scans the stacked layers with each
layer's attention window as a scanned input, the port loops over the
layers and indexes the stacked parameters; `remat` is
`torch.utils.checkpoint` (JAX's `jax.checkpoint` with
`dots_with_no_batch_dims_saveable`): outputs and gradients are the same
with and without it.

The formulas are JAX's to the letter, because bf16 results move with
their order: rmsnorm normalises in fp32, casts back, then scales;
attention takes fp32 logits, a -1e30 fill and an fp32 softmax whose
weights are cast to v's dtype (`scaled_dot_product_attention` is not used:
it takes no softcap and rounds otherwise).  The JAX package's
`param_shardings` (PartitionSpecs of a device mesh) has no counterpart:
the port holds the weights on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import init_generator
from repro_torch.sparse.segment import take_rows


@dataclasses.dataclass(frozen=True)
class MoESettings:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    # EP divisibility: expert arrays are allocated at this count (phantom
    # experts are masked out of routing) -- e.g. qwen2-moe 60 -> 64 on a
    # 16-wide model axis.  None = n_experts.
    n_experts_padded: int | None = None

    @property
    def e_alloc(self) -> int:
        return self.n_experts_padded or self.n_experts


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 1e4
    rope_fraction: float = 1.0          # glm4 uses 0.5 (partial rotary)
    attn_softcap: Optional[float] = None   # gemma2: 50.0
    logit_softcap: Optional[float] = None  # gemma2: 30.0
    query_scale: Optional[float] = None    # gemma2: 1/sqrt(256)
    window_pattern: tuple = (0,)        # cycled over layers; 0 = global attn
    post_norms: bool = False            # gemma2 sandwich norms
    tie_embeddings: bool = False
    moe: Optional[MoESettings] = None
    dtype: Any = torch.bfloat16
    remat: bool = True

    @property
    def windows(self):
        pat = self.window_pattern
        return tuple(pat[l % len(pat)] for l in range(self.n_layers))

    def param_count(self) -> int:
        c = self.vocab * self.d_model
        if not self.tie_embeddings:
            c += self.vocab * self.d_model
        per = (self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
               + self.n_heads * self.d_head * self.d_model)
        if self.moe:
            per += self.d_model * self.moe.n_experts
            per += 3 * self.moe.n_experts * self.d_model * self.moe.d_ff_expert
            per += 3 * self.d_model * self.moe.d_ff_expert * self.moe.n_shared
        else:
            per += 3 * self.d_model * self.d_ff
        return c + self.n_layers * per

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        per_active = (self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
                      + self.n_heads * self.d_head * self.d_model
                      + self.d_model * self.moe.n_experts
                      + 3 * self.d_model * self.moe.d_ff_expert
                      * (self.moe.top_k + self.moe.n_shared))
        return 2 * self.vocab * self.d_model + self.n_layers * per_active


# ----------------------------------------------------------------------------
# building blocks
# ----------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x, positions, theta, fraction):
    """x: (..., T, n, dh); positions: (..., T).  Rotates the first
    int(dh * fraction) dims, rounded down to even, at fp32 angles."""
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    half = rot // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., T, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:rot]
    xr = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos,
                    x[..., rot:].to(torch.float32)], dim=-1)
    return xr.to(x.dtype)


def _softcap(x, cap):
    return cap * torch.tanh(x / cap) if cap else x


def attention(q, k, v, q_pos, k_pos, *, window, softcap, scale,
              k_valid=None):
    """q: (B, Tq, H, dh); k/v: (B, Tk, KV, dh).  Causal + optional sliding
    window (window > 0) + optional logit softcap; head h reads kv head
    h // G."""
    B, Tq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, Tq, KV, G, dh)
    logits = torch.einsum("btkgd,bskd->bktgs",
                          q.to(torch.float32) * scale, k.to(torch.float32))
    logits = _softcap(logits, softcap)
    causal = k_pos[:, None, :] <= q_pos[:, :, None]               # (B,Tq,Tk)
    if window is not None and window > 0:
        causal = causal & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    if k_valid is not None:
        causal = causal & k_valid[:, None, :]
    mask = causal[:, None, :, None, :]                            # b1t1s
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bktgs,bskd->btkgd", w.to(v.dtype), v)
    return o.reshape(B, Tq, H * dh)


def swiglu(x, w1, w3, w2):
    return (torch.nn.functional.silu(x @ w1) * (x @ w3)) @ w2


# ----------------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------------

def _normal(gen, dev, dt, d, *shape):
    """JAX's `nrm`: N(0, 1) / sqrt(shape[-2]) drawn in fp32, cast to dt;
    a stacked (L, ...) weight is drawn a layer at a time (its fp32
    temporary is one layer's)."""
    scale = 1.0 / torch.sqrt(torch.tensor(
        float(shape[-2] if len(shape) > 1 else d), dtype=torch.float32))
    out = torch.empty(shape, dtype=dt, device=dev)
    for part in (out if len(shape) > 2 else [out]):
        part.copy_((torch.randn(part.shape, generator=gen, device=dev)
                    * scale.to(dev)).to(dt))
    return out


class LM(nn.Module):
    def __init__(self, cfg: LMConfig, generator=None, device=None):
        super().__init__()
        dev, gen = init_generator(generator, device)
        self.cfg = cfg
        L, d, H, KV, dh = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, cfg.d_head)
        dt = cfg.dtype

        def nrm(*shape):
            return _normal(gen, dev, dt, d, *shape)

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        self.embed = nn.Parameter(nrm(cfg.vocab, d))
        self.ln_f = nn.Parameter(ones(d))
        attn = {"ln": ones(L, d), "wq": nrm(L, d, H * dh),
                "wk": nrm(L, d, KV * dh), "wv": nrm(L, d, KV * dh),
                "wo": nrm(L, H * dh, d)}
        if cfg.post_norms:
            attn["ln_post"] = ones(L, d)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(nrm(d, cfg.vocab))
        if cfg.moe:
            m = cfg.moe
            mlp = {"ln": ones(L, d),
                   "router": nrm(L, d, m.e_alloc).to(torch.float32),
                   "w1": nrm(L, m.e_alloc, d, m.d_ff_expert),
                   "w3": nrm(L, m.e_alloc, d, m.d_ff_expert),
                   "w2": nrm(L, m.e_alloc, m.d_ff_expert, d)}
            if m.n_shared:
                ffs = m.n_shared * m.d_ff_expert
                mlp["sw1"] = nrm(L, d, ffs)
                mlp["sw3"] = mlp["sw1"].clone()   # JAX draws both from one key
                mlp["sw2"] = nrm(L, ffs, d)
        else:
            mlp = {"ln": ones(L, d), "w1": nrm(L, d, cfg.d_ff),
                   "w3": nrm(L, d, cfg.d_ff), "w2": nrm(L, cfg.d_ff, d)}
        if cfg.post_norms:
            mlp["ln_post"] = ones(L, d)
        self.attn = nn.ParameterDict(attn)
        self.mlp = nn.ParameterDict(mlp)

    # -- pieces -------------------------------------------------------------
    def _embed(self, tokens):
        cfg = self.cfg
        x = take_rows(self.embed, tokens).to(cfg.dtype)
        if cfg.tie_embeddings:
            # a 0-dim CPU tensor rounds the scale to dtype, as JAX does,
            # without a blocking copy to the card
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
        return x

    def _logits(self, x):
        cfg = self.cfg
        x = rmsnorm(x, self.ln_f)
        un = self.embed.T if cfg.tie_embeddings else self.unembed
        logits = (x @ un.to(cfg.dtype)).to(torch.float32)
        return _softcap(logits, cfg.logit_softcap)

    def _layers(self):
        """Per layer: ({attn name: its slice}, {mlp name: its slice}),
        one `unbind` a stacked parameter (one backward node each)."""
        attn = {k: v.unbind(0) for k, v in self.attn.items()}
        mlp = {k: v.unbind(0) for k, v in self.mlp.items()}
        return [({k: v[l] for k, v in attn.items()},
                 {k: v[l] for k, v in mlp.items()})
                for l in range(self.cfg.n_layers)]

    def _mlp(self, h, mp, mesh):
        cfg = self.cfg
        if not cfg.moe:
            return swiglu(h, mp["w1"], mp["w3"], mp["w2"]), None
        lead = h.shape[:-1]
        y, aux = moe_lib.moe_apply(h.reshape(-1, h.shape[-1]), mp, cfg.moe,
                                   mesh=mesh)
        y = y.reshape(lead + (-1,))
        if cfg.moe.n_shared:
            y = y + swiglu(h, mp["sw1"], mp["sw3"], mp["sw2"])
        return y, aux

    def _layer(self, x, ap, mp, window, positions, mesh=None):
        cfg = self.cfg
        B, T, d = x.shape
        H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        h = rmsnorm(x, ap["ln"])
        q = (h @ ap["wq"]).reshape(B, T, H, dh)
        k = (h @ ap["wk"]).reshape(B, T, KV, dh)
        v = (h @ ap["wv"]).reshape(B, T, KV, dh)
        q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
        scale = cfg.query_scale if cfg.query_scale else dh ** -0.5
        o = attention(q, k, v, positions, positions, window=window,
                      softcap=cfg.attn_softcap, scale=scale)
        o = o @ ap["wo"]
        if cfg.post_norms:
            o = rmsnorm(o, ap["ln_post"])
        x = x + o
        h = rmsnorm(x, mp["ln"])
        y, aux = self._mlp(h, mp, mesh)
        if cfg.post_norms:
            y = rmsnorm(y, mp["ln_post"])
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + y, aux

    # -- the JAX functions --------------------------------------------------
    def forward(self, tokens, mesh=None):
        """tokens (B, T) -> (logits (B, T, V) fp32, the layers' summed aux;
        0.0 for a dense model)."""
        cfg = self.cfg
        B, T = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(T, dtype=torch.int32,
                                 device=x.device).expand(B, T)
        auxes = []
        for (ap, mp), window in zip(self._layers(), cfg.windows):
            if cfg.remat:
                x, aux = checkpoint(self._layer, x, ap, mp, window,
                                    positions, mesh, use_reentrant=False)
            else:
                x, aux = self._layer(x, ap, mp, window, positions, mesh)
            auxes.append(aux)
        return self._logits(x), torch.sum(torch.stack(auxes))

    def loss(self, tokens, labels, mesh=None):
        """`loss_fn`: mean next-token NLL over labels >= 0, plus 1e-2 aux.
        A label in [-V, -1] reads logit label + V and one below -V reads
        NaN, as `jnp.take_along_axis` does; the masked terms are picked
        with `where`, so they leave no NaN in the loss or its gradient."""
        logits, aux = self.forward(tokens, mesh=mesh)
        V = logits.shape[-1]
        lse = torch.logsumexp(logits, dim=-1)
        idx = labels.long()
        idx = torch.where(idx < 0, idx + V, idx)
        inside = (idx >= 0) & (idx < V)
        ll = torch.gather(logits, -1, idx.clamp(0, V - 1)[..., None])[..., 0]
        ll = torch.where(inside, ll, float("nan"))
        mask = labels >= 0
        nll = torch.sum(torch.where(mask, lse - ll, 0.0)) / torch.clamp(
            torch.sum(mask), min=1)
        return nll + 1e-2 * aux

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos, mesh=None):
        """One greedy decode step.  tokens (B,), pos the current index (an
        int or a 0-dim tensor).  Returns (next_tokens (B,) int32, cache):
        the cache is donated, as the JAX step's is -- written in place at
        ring slot pos % W and returned.  Among tied logits the lowest
        index wins, as `jnp.argmax`'s."""
        cfg = self.cfg
        B = tokens.shape[0]
        H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        x = self._embed(tokens[:, None])
        if isinstance(pos, torch.Tensor):
            positions = pos.to(x.device, torch.int32).reshape(1, 1).expand(
                B, 1)
        else:     # a fill, not a blocking host-to-card copy a step
            positions = torch.full((B, 1), pos, dtype=torch.int32,
                                   device=x.device)
        W = cache["k"].shape[2]
        slot = pos % W
        scale = cfg.query_scale if cfg.query_scale else dh ** -0.5
        for l, ((ap, mp), window) in enumerate(zip(self._layers(),
                                                   cfg.windows)):
            kc, vc, pc = cache["k"][l], cache["v"][l], cache["pos"][l]
            h = rmsnorm(x, ap["ln"])
            q = rope((h @ ap["wq"]).reshape(B, 1, H, dh), positions,
                     cfg.rope_theta, cfg.rope_fraction)
            k = rope((h @ ap["wk"]).reshape(B, 1, KV, dh), positions,
                     cfg.rope_theta, cfg.rope_fraction)
            v = (h @ ap["wv"]).reshape(B, 1, KV, dh)
            kc[:, slot] = k[:, 0]
            vc[:, slot] = v[:, 0]
            pc[:, slot] = positions[:, 0]
            o = attention(q, kc, vc, positions, pc, window=window,
                          softcap=cfg.attn_softcap, scale=scale,
                          k_valid=pc >= 0)
            o = o @ ap["wo"]
            if cfg.post_norms:
                o = rmsnorm(o, ap["ln_post"])
            x = x + o
            h = rmsnorm(x, mp["ln"])
            y, _ = self._mlp(h, mp, mesh)
            if cfg.post_norms:
                y = rmsnorm(y, mp["ln_post"])
            x = x + y
        logits = self._logits(x)
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        return nxt, cache


def init_params(cfg: LMConfig, generator=None, device=None) -> LM:
    """An `LM` with JAX's tree names, shapes, scales and dtypes, drawn from
    `generator` on `device` (None = CUDA).  `jax.random` is not reproduced:
    JAX's weights come in through `convert.load_jax_params`."""
    return LM(cfg, generator, device)


def init_cache(cfg: LMConfig, batch: int, max_seq: int, device=None):
    """KV cache dict on `device` (None = CUDA).  For pure-SWA models (all
    windows > 0) the cache is a ring buffer of the window size -- what
    makes 500k-token decode feasible (DESIGN.md sec. 6)."""
    dev = resolve_device(device)
    win = max(cfg.windows) if all(w > 0 for w in cfg.windows) else 0
    W = min(max_seq, win) if win else max_seq
    L, KV, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    return {
        "k": torch.zeros((L, batch, W, KV, dh), dtype=cfg.dtype, device=dev),
        "v": torch.zeros((L, batch, W, KV, dh), dtype=cfg.dtype, device=dev),
        "pos": torch.full((L, batch, W), -1, dtype=torch.int32, device=dev),
    }
