"""Shared pieces of the five LM architectures, the port of
`repro/configs/lm_common.py`.

Shapes (assignment):
  train_4k     seq 4096,  global_batch 256   -> train_step (loss+grad+adamw)
  prefill_32k  seq 32768, global_batch 32    -> forward (logits)
  decode_32k   seq 32768 KV cache, batch 128 -> serve_step (1 new token)
  long_500k    seq 524288 KV cache, batch 1  -> serve_step; ONLY for archs
               with a sub-quadratic (sliding-window) component.

Sharding: batch over dp axes; TP/EP over `model`; decode caches shard batch
over dp and heads over model when divisible, long-context caches shard the
SEQUENCE over everything.  `build_lm_dryrun` builds the JAX module's
spec on the meta device: the step traced over a `StackedMesh`, each
argument's split the JAX spec's PartitionSpec.  The smoke runs on `device`
(None = CUDA, raising without a card; "cpu" for the CPU tests), its random
draws from one torch.Generator seeded 0.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.common import (DryrunSpec, MeshAxes, S,
                                        abstract, apply_params, map_splits,
                                        param_tree)
from repro_torch.models import lm as L
from repro_torch.models.common import init_generator
from repro_torch.models.moe import MoEShard
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step)

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


def _param_splits(cfg: L.LMConfig, model_axis="model") -> dict:
    """The JAX package's `lm.param_shardings`: Megatron TP over
    `model_axis` (heads / ff / experts / vocab), the embedding split on
    d_model."""
    M = model_axis
    s = {"embed": S(None, M), "ln_f": S(None),
         "attn": {"ln": S(None, None), "wq": S(None, None, M),
                  "wk": S(None, None, M), "wv": S(None, None, M),
                  "wo": S(None, M, None)}}
    if cfg.post_norms:
        s["attn"]["ln_post"] = S(None, None)
    if not cfg.tie_embeddings:
        s["unembed"] = S(None, M)
    if cfg.moe:
        s["mlp"] = {"ln": S(None, None), "router": S(None, None, None),
                    "w1": S(None, M, None, None), "w3": S(None, M, None, None),
                    "w2": S(None, M, None, None)}
        if cfg.moe.n_shared:
            s["mlp"].update(sw1=S(None, None, M), sw3=S(None, None, M),
                            sw2=S(None, M, None))
    else:
        s["mlp"] = {"ln": S(None, None), "w1": S(None, None, M),
                    "w3": S(None, None, M), "w2": S(None, M, None)}
    if cfg.post_norms:
        s["mlp"]["ln_post"] = S(None, None)
    return s


def _cache_splits(axes: MeshAxes, long: bool) -> dict:
    dp = tuple(axes.dp)
    if long:
        # batch=1: shard the cache SEQUENCE over every axis
        kv = S(None, None, (*dp, axes.tp), None, None)
        pos = S(None, None, (*dp, axes.tp))
    else:
        kv = S(None, dp, None, None, None)
        pos = S(None, dp, None)
    return {"k": kv, "v": kv, "pos": pos}


def _zero_split(split, leaf, dp_last: str, data_size: int):
    """ZeRO-1: an optimizer moment additionally splits its first
    divisible unsplit dim over the innermost dp axis (unless it is split
    over it already)."""
    parts = list(split) + [None] * (len(leaf.shape) - len(split))
    used = {a for p in parts for a in (p if isinstance(p, tuple) else (p,))}
    if dp_last not in used:
        for i, (p, n) in enumerate(zip(parts, leaf.shape)):
            if p is None and n % data_size == 0 and n >= data_size:
                parts[i] = dp_last
                break
    return S(*parts)


def build_lm_dryrun(cfg: L.LMConfig, shape: str, mesh, axes: MeshAxes,
                    train_cfg: TrainConfig | None = None,
                    variant: dict | None = None) -> DryrunSpec:
    """variant (hillclimb knobs): moe_fsdp_axis, moe_quant, token_axes,
    capacity_factor, microbatches, remat, cache_seq_shard.  `mesh`: a
    `StackedMesh` (on the meta device for the dry run)."""
    v = variant or {}
    if v.get("capacity_factor") and cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=v["capacity_factor"]))
    if "remat" in v:
        cfg = dataclasses.replace(cfg, remat=v["remat"])
    sh = SHAPES[shape]
    dp = tuple(axes.dp)
    psplit = _param_splits(cfg, model_axis=axes.tp)
    if v.get("moe_fsdp_axis") and cfg.moe:
        fa = v["moe_fsdp_axis"]
        psplit["mlp"]["w1"] = S(None, axes.tp, fa, None)
        psplit["mlp"]["w3"] = S(None, axes.tp, fa, None)
        psplit["mlp"]["w2"] = S(None, axes.tp, None, fa)
    model = L.init_params(cfg, None, mesh.device)
    params_abs = param_tree(model)
    mshard = _moe_shard(cfg, mesh, axes, v)

    if sh["kind"] == "train":
        tc = train_cfg or TrainConfig(optimizer=AdamWConfig(),
                                      microbatches=v.get("microbatches", 1))

        def loss(p, b):
            return apply_params(model, p, "loss")(b["tokens"], b["labels"],
                                                  mesh=mshard)
        step = make_train_step(loss, tc)
        state_abs = abstract(init_state(tc, params_abs).tree())
        data_size = dict(zip(mesh.axis_names, mesh.shape))[dp[-1]]
        mu_split = map_splits(lambda s_, leaf: _zero_split(
            s_, leaf, dp[-1], data_size), psplit, params_abs)
        st_split = {"params": psplit,
                    "opt": {"mu": mu_split, "nu": mu_split, "step": S()},
                    "err": None}
        if tc.microbatches > 1:
            mb = tc.microbatches
            bs = (mb, sh["batch"] // mb, sh["seq"])
            bsplit = S(None, dp, None)
        else:
            bs = (sh["batch"], sh["seq"])
            bsplit = S(dp, None)
        batch_abs = {k: torch.empty(bs, dtype=torch.int32, device=mesh.device)
                     for k in ("tokens", "labels")}
        return DryrunSpec(fn=step, args=(state_abs, batch_abs),
                          in_splits=(st_split, {"tokens": bsplit,
                                                "labels": bsplit}),
                          out_splits=(st_split, None),
                          note=f"train_step bs={sh['batch']} seq={sh['seq']}")

    if sh["kind"] == "prefill":
        def fwd(p, t):
            return apply_params(model, p)(t, mesh=mshard)[0]
        toks = torch.empty((sh["batch"], sh["seq"]), dtype=torch.int32,
                           device=mesh.device)
        return DryrunSpec(fn=fwd, args=(params_abs, toks),
                          in_splits=(psplit, S(dp, None)),
                          out_splits=S(dp, None, axes.tp),
                          note=f"prefill bs={sh['batch']} seq={sh['seq']}")

    # decode
    long = sh["seq"] > 100_000 or v.get("cache_seq_shard", False)
    cache = abstract(L.init_cache(cfg, sh["batch"], sh["seq"],
                                  device=mesh.device))
    csplit = _cache_splits(axes, long)

    def step(p, c, t, pos):
        return apply_params(model, p, "decode_step")(c, t, pos, mesh=mshard)
    toks = torch.empty((sh["batch"],), dtype=torch.int32, device=mesh.device)
    pos = torch.empty((), dtype=torch.int32, device=mesh.device)
    tsplit = S(dp) if sh["batch"] >= 8 else S()
    return DryrunSpec(fn=step, args=(params_abs, cache, toks, pos),
                      in_splits=(psplit, csplit, tsplit, S()),
                      out_splits=(tsplit, csplit),
                      note=f"decode bs={sh['batch']} kv={sh['seq']}"
                           f"{' seq-sharded-cache' if long else ''}")


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
