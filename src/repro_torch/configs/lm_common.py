"""Shared pieces of the five LM architectures, the port of
`repro/configs/lm_common.py`.

Shapes (assignment):
  train_4k     seq 4096,  global_batch 256   -> train_step (loss+grad+adamw)
  prefill_32k  seq 32768, global_batch 32    -> forward (logits)
  decode_32k   seq 32768 KV cache, batch 128 -> serve_step (1 new token)
  long_500k    seq 524288 KV cache, batch 1  -> serve_step; ONLY for archs
               with a sub-quadratic (sliding-window) component.

The JAX module's `build_lm_dryrun` lowers these shapes for a device mesh
(batch over the dp axes, TP / EP over `model`, caches sharded); its
counterpart comes with the port's dry run (ROADMAP A16 part 3).  The
smoke runs on `device` (None = CUDA, raising without a card; "cpu" for
the CPU tests), its random draws from one torch.Generator seeded 0.
"""
from __future__ import annotations

import torch

from repro_torch.configs.common import MeshAxes
from repro_torch.models import lm as L
from repro_torch.models.common import init_generator
from repro_torch.models.moe import MoEShard

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def _moe_shard(cfg: L.LMConfig, mesh, axes: MeshAxes, variant=None):
    if cfg.moe is None:
        return None
    v = variant or {}
    return MoEShard(mesh=mesh,
                    token_axes=tuple(v.get("token_axes", axes.all)),
                    expert_axis=axes.tp,
                    fsdp_axis=v.get("moe_fsdp_axis"),
                    quant_dispatch=v.get("moe_quant", False))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"smoke failed: {what}")


def smoke_lm(cfg: L.LMConfig, device=None):
    """Reduced-config forward + loss gradient + one decode step:
    shapes + finiteness."""
    dev, gen = init_generator(None, device)
    small = L.LMConfig(
        name=cfg.name + "-smoke", n_layers=2, d_model=64,
        n_heads=min(4, cfg.n_heads), n_kv_heads=min(2, cfg.n_kv_heads),
        d_head=16, d_ff=128, vocab=256, rope_fraction=cfg.rope_fraction,
        attn_softcap=cfg.attn_softcap, logit_softcap=cfg.logit_softcap,
        window_pattern=tuple(min(w, 8) for w in cfg.window_pattern),
        post_norms=cfg.post_norms, tie_embeddings=cfg.tie_embeddings,
        moe=None if cfg.moe is None else L.MoESettings(
            n_experts=8, top_k=min(2, cfg.moe.top_k), d_ff_expert=32,
            n_shared=min(1, cfg.moe.n_shared)),
        dtype=torch.float32, remat=False)
    model = L.init_params(small, gen, dev)
    toks = torch.randint(0, small.vocab, (2, 16), generator=gen, device=dev,
                         dtype=torch.int32)
    logits, _ = model(toks)
    _check(logits.shape == (2, 16, small.vocab), "LM logits shape")
    _check(bool(torch.isfinite(logits).all()), "NaN in smoke forward")
    loss = model.loss(toks, toks)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    _check(bool(torch.isfinite(loss)), "LM loss")
    _check(all(bool(torch.isfinite(g).all()) for g in grads),
           "LM gradients")
    cache = L.init_cache(small, 2, 32, device=dev)
    nxt, cache = model.decode_step(cache, toks[:, 0], 0)
    _check(nxt.shape == (2,), "decode step tokens")
