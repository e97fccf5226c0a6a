"""The LM half of the port at its configurations' full width on one card,
each leg checked: `chip_smoke.py` phase 20.

    python scripts/torch_lm_card.py [--seed 1] [--out FILE.json]

It runs on the card (it raises without one).  Weights are drawn on the card
from --seed; the legs run one after another, each freeing the card.

Legs (every check raises; the script exits non-zero on the first):
  a  h2o-danube-1.8b, full config (24 layers, d_model 2560, 32 / 8 heads,
     d_head 80, vocab 32000, window 4096 on every layer; bf16).  Serving
     at `decode_32k`'s shape: batch 128, max_seq 32768, so `init_cache`
     gives the 4096-slot ring buffer (32.2 GB); 64 greedy steps through
     `make_serve_step`.  `long_500k`: batch 1, 16 steps from position
     524,272.  Checks, in fp32 at 2 layers and full width: 4160 tokens
     teacher-forced through `decode_step` at batch 1 (the buffer wraps at
     4096): each of the last 64 next tokens equals `forward`'s argmax over
     the same tokens, a differing one allowed only where `forward`'s
     logits tie it with the argmax to TIE_TOL of their largest magnitude
     (the count is logged); the card's `forward` logits of a (2, 64) batch
     equal the CPU path's.
  b  qwen2-moe-a2.7b, full config (24 layers, d_model 2048, 64 experts
     allocated, 60 routed, top-4, 4 shared; bf16).  Serving: batch 8, a
     4096-token cache, 32 greedy steps (decode_32k's batch 128 over 32768
     tokens would need ~824 GB of cache).  Check, in fp32 at 2 layers and
     full width on a (2, 32) batch: logits, aux and every layer's routing
     (top-k indices exactly, weights) equal the CPU path's, and no copy
     reaches experts 60-63.
  c  gemma2-2b, full config (26 layers, d_model 2304, tied vocab 256000,
     softcaps, sandwich norms, 4096 / global windows; bf16 weights, fp32
     AdamW moments, remat on).  Training: 3 steps of `make_train_step`
     (lr 3e-4 from the first step: a warm-up step's smaller update
     rounds away in bf16) on `synthetic_lm_batches` at `train_4k`'s
     sequence 4096, batch 1 (`train_4k`'s global batch of 256 belongs to
     a pod).  Checks: the loss finite and most of a weight moved; at 2
     layers, full width, fp32 and seq 64: the first step's loss and
     gradients equal the CPU path's, remat on equals off, and the
     parameters and AdamW moments after one `make_train_step` with the
     same optimizer, both sides stepping on the card's gradients, equal
     the CPU path's.
  d  `smoke_lm` of each of the five configs on the card.

Tolerances: rtol 1e-4 and atol 1e-5 card against CPU and remat against
none, the atol in units of a tensor's largest entry once that passes 1.
Matmuls run in fp32 where fp32 (TF32 off).  Each leg logs its wall
seconds, the timed sections (host clock around synchronised work) and the
peak memory.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_models_card import Card, check_close, gib  # noqa: E402

TIE_TOL = 1e-5        # (a): a decode token may differ only at such a tie


def log(msg: str) -> None:
    print(f"[20 lm] {msg}", flush=True)


def median_ms(xs) -> float:
    return float(np.median(xs)) * 1e3


def reduced(cfg, n_layers=2):
    """The config at full width, n_layers deep, fp32, remat off."""
    return dataclasses.replace(cfg, n_layers=n_layers, dtype=torch.float32,
                               remat=False)


def greedy(card, model, cache, tokens, pos0, steps):
    """`steps` greedy steps through `make_serve_step` from position pos0:
    (the last tokens, each step's seconds)."""
    from repro_torch.train import make_serve_step

    serve = make_serve_step(lambda p, c, t, i: model.decode_step(c, t, i))
    secs = []
    for i in range(steps):
        (tokens, cache), s = card.timed(
            lambda: serve(None, cache, tokens, pos0 + i))
        secs.append(s)
    if not bool(((tokens >= 0) & (tokens < model.cfg.vocab)).all()):
        raise AssertionError("greedy tokens outside the vocabulary")
    return tokens, secs


# ---------------------------------------------------------------------------
# (a) h2o-danube-1.8b: decode_32k, long_500k, the ring buffer
# ---------------------------------------------------------------------------

def leg_a(card, seed):
    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.configs.lm_common import SHAPES
    from repro_torch.models import lm as L

    cfg = h2o_danube_1_8b.CONFIG
    sh, lg = SHAPES["decode_32k"], SHAPES["long_500k"]
    card.reset_peak()
    model, init_s = card.timed(lambda: L.init_params(cfg, card.gen(seed),
                                                     card.dev))
    n_params = sum(p.numel() for p in model.parameters())
    cache = L.init_cache(cfg, sh["batch"], sh["seq"], device=card.dev)
    W = cache["k"].shape[2]
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    toks = torch.randint(0, cfg.vocab, (sh["batch"],), dtype=torch.int32,
                         generator=card.gen(seed + 1), device=card.dev)
    _, secs = greedy(card, model, cache, toks, 0, 64)
    ms = median_ms(secs[1:])
    decode_peak = card.peak()
    del cache
    card.reset_peak()
    cache = L.init_cache(cfg, lg["batch"], lg["seq"], device=card.dev)
    _, lsecs = greedy(card, model, cache, toks[:1], lg["seq"] - 16, 16)
    lms = median_ms(lsecs[1:])
    long_peak = card.peak()
    del cache, model
    log(f"(a) {cfg.name}: {n_params} parameters (bf16) drawn in "
        f"{init_s:.2f} s; decode_32k batch {sh['batch']}, max_seq "
        f"{sh['seq']} -> a {W}-slot ring buffer ({cache_bytes / 1e9:.1f} GB)"
        f": 64 greedy steps, first {secs[0] * 1e3:.1f} ms, median "
        f"{ms:.2f} ms a step, {sh['batch'] / ms * 1e3:.0f} tokens/s, peak "
        f"{gib(decode_peak)}; long_500k batch 1 from position "
        f"{lg['seq'] - 16}: median {lms:.2f} ms a step, peak "
        f"{gib(long_peak)}")

    # fp32, 2 layers: decode through the wrapped ring buffer == forward
    card.reset_peak()
    small = reduced(cfg)
    model = L.init_params(small, card.gen(seed + 2), card.dev)
    last = 64
    T = max(small.windows) + last         # 4160: the buffer wraps
    seq = torch.randint(0, cfg.vocab, (1, T), dtype=torch.int32,
                        generator=card.gen(seed + 3), device=card.dev)
    cache = L.init_cache(small, 1, T, device=card.dev)
    if cache["k"].shape[2] != max(small.windows):
        raise AssertionError("(a) the ring buffer is not the window")
    t0 = time.perf_counter()
    nxt = []
    for t in range(T):
        tok, cache = model.decode_step(cache, seq[:, t], t)
        if t >= T - last:
            nxt.append(tok)
    card.sync()
    tf_s = time.perf_counter() - t0
    with torch.no_grad():
        logits = model(seq)[0][0, T - last:]
    got = torch.cat(nxt)
    want = torch.argmax(logits, dim=-1).to(torch.int32)
    scale = float(logits.abs().max())
    gap = logits.max(dim=-1).values - logits.gather(
        -1, got.long()[:, None])[:, 0]
    ties = int((got != want).sum())
    if bool((gap[got != want] > TIE_TOL * scale).any()):
        raise AssertionError(f"(a) decode tokens differ from forward's "
                             f"argmax beyond a tie ({ties} of {last})")
    # the card's forward against the CPU path on a (2, 64) batch
    toks = torch.randint(0, cfg.vocab, (2, 64), dtype=torch.int32,
                         generator=card.gen(seed + 4), device=card.dev)
    cpu = copy.deepcopy(model).cpu()
    with torch.no_grad():
        err = check_close("(a) forward logits card/CPU", model(toks)[0],
                          cpu(toks.cpu())[0])
    del cpu, model, cache, logits
    log(f"(a) fp32 at 2 layers, full width: {T} tokens teacher-forced "
        f"through decode_step ({tf_s:.2f} s, the {T - last}-slot buffer "
        f"wrapped): "
        f"the last {last} next tokens = forward's argmax ({ties} near-ties "
        f"within {TIE_TOL} of |logit| max); forward card = CPU on (2, 64) "
        f"(max |diff| {err:.3g}); peak {gib(card.peak())}")
    return {"n_params": n_params, "init_s": init_s, "cache_slots": W,
            "cache_bytes": cache_bytes, "decode_step_s": secs,
            "decode_ms": ms, "tokens_per_s": sh["batch"] / ms * 1e3,
            "decode_peak_bytes": decode_peak, "long_step_s": lsecs,
            "long_ms": lms, "long_peak_bytes": long_peak,
            "teacher_forced_s": tf_s, "near_ties": ties,
            "max_abs_err": err, "check_peak_bytes": card.peak()}


# ---------------------------------------------------------------------------
# (b) qwen2-moe-a2.7b: serving, routing card = CPU
# ---------------------------------------------------------------------------

class RouteLog:
    """Records every `_route` call's top-k of the MoE layer while on."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.orig, self.calls = moe, moe._route, []

    def __enter__(self):
        def rec(*a, **k):
            out = self.orig(*a, **k)
            self.calls.append((out[0].cpu(), out[1].detach().cpu()))
            return out
        self.moe._route = rec
        return self

    def __exit__(self, *exc):
        self.moe._route = self.orig


def leg_b(card, seed):
    from repro_torch.configs import qwen2_moe_a2_7b
    from repro_torch.models import lm as L

    cfg = qwen2_moe_a2_7b.CONFIG
    batch, ctx, steps = 8, 4096, 32
    card.reset_peak()
    model, init_s = card.timed(lambda: L.init_params(cfg, card.gen(seed + 10),
                                                     card.dev))
    n_params = sum(p.numel() for p in model.parameters())
    cache = L.init_cache(cfg, batch, ctx, device=card.dev)
    toks = torch.randint(0, cfg.vocab, (batch,), dtype=torch.int32,
                         generator=card.gen(seed + 11), device=card.dev)
    _, secs = greedy(card, model, cache, toks, 0, steps)
    ms = median_ms(secs[1:])
    peak = card.peak()
    del cache, model
    log(f"(b) {cfg.name}: {n_params} parameters allocated (bf16, "
        f"{cfg.moe.e_alloc} experts, {cfg.moe.n_experts} routed) drawn in "
        f"{init_s:.2f} s; batch {batch} over a {ctx}-token cache: {steps} "
        f"greedy steps, first {secs[0] * 1e3:.1f} ms, median {ms:.2f} ms a "
        f"step, {batch / ms * 1e3:.0f} tokens/s, peak {gib(peak)}")

    card.reset_peak()
    small = reduced(cfg)
    model = L.init_params(small, card.gen(seed + 12), card.dev)
    toks = torch.randint(0, cfg.vocab, (2, 32), dtype=torch.int32,
                         generator=card.gen(seed + 13), device=card.dev)
    cpu = copy.deepcopy(model).cpu()
    with torch.no_grad(), RouteLog() as on_card:
        logits, aux = model(toks)
    with torch.no_grad(), RouteLog() as on_cpu:
        clogits, caux = cpu(toks.cpu())
    errs = [check_close("(b) logits card/CPU", logits, clogits),
            check_close("(b) aux card/CPU", aux, caux)]
    if len(on_card.calls) != small.n_layers or \
            len(on_cpu.calls) != small.n_layers:
        raise AssertionError("(b) not one routing a layer")
    for l, ((ti, tv), (ci, cv)) in enumerate(zip(on_card.calls,
                                                 on_cpu.calls)):
        if not torch.equal(ti, ci):
            raise AssertionError(f"(b) layer {l}: routing card != CPU")
        errs.append(check_close(f"(b) layer {l} routing weights", tv, cv))
        if int(ti.max()) >= cfg.moe.n_experts:
            raise AssertionError(f"(b) layer {l}: a copy reached a "
                                 f"phantom expert")
    del cpu, model
    log(f"(b) fp32 at 2 layers, full width, (2, 32) tokens: logits, aux "
        f"and both layers' routing card = CPU (max |diff| {max(errs):.3g}), "
        f"no copy past expert {cfg.moe.n_experts - 1}; peak "
        f"{gib(card.peak())}")
    return {"n_params": n_params, "init_s": init_s, "batch": batch,
            "cache_tokens": ctx, "step_s": secs, "decode_ms": ms,
            "tokens_per_s": batch / ms * 1e3, "peak_bytes": peak,
            "max_abs_err": max(errs), "check_peak_bytes": card.peak()}


# ---------------------------------------------------------------------------
# (c) gemma2-2b: train_4k steps
# ---------------------------------------------------------------------------

def loss_and_grads(model, toks, labels):
    loss = model.loss(toks, labels)
    names, params = zip(*model.named_parameters())
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))


def leg_c(card, seed):
    from repro_torch.configs import gemma2_2b
    from repro_torch.configs.lm_common import SHAPES
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.models import lm as L
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.train_step import init_state

    cfg = gemma2_2b.CONFIG
    seq, batch, steps = SHAPES["train_4k"]["seq"], 1, 3
    card.reset_peak()
    model, init_s = card.timed(lambda: L.init_params(cfg, card.gen(seed + 20),
                                                     card.dev))
    n_params = sum(p.numel() for p in model.parameters())
    # lr 3e-4 from the first step: a smaller update rounds away in bf16
    tc = TrainConfig(optimizer=AdamWConfig(lr=3e-4, warmup_steps=0))
    step = make_train_step(lambda p, b: model.loss(b[0], b[1]), tc)
    state = init_state(tc, dict(model.named_parameters())).tree()
    before = model.attn["wq"][0].detach().clone()
    data = synthetic_lm_batches(cfg.vocab, batch, seq, seed=seed,
                                n_batches=steps)
    secs, losses = [], []
    for toks, labels in data:
        b = (torch.as_tensor(toks, device=card.dev),
             torch.as_tensor(labels, device=card.dev))
        (state, info), s = card.timed(lambda: step(state, b))
        secs.append(s)
        losses.append(float(info["loss"]))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"(c) loss not finite: {losses}")
    moved = float((model.attn["wq"][0].detach() != before).float().mean())
    if not moved > 0.5:
        raise AssertionError(f"(c) the parameters did not move (a share "
                             f"{moved} of wq[0] changed)")
    peak = card.peak()
    del state, step, model
    log(f"(c) {cfg.name}: {n_params} parameters (bf16, fp32 AdamW moments, "
        f"remat on) drawn in {init_s:.2f} s; train_4k seq {seq}, batch "
        f"{batch}: {steps} steps, first {secs[0]:.3f} s, then "
        f"{np.mean(secs[1:]):.3f} s a step, "
        f"{batch * seq / np.mean(secs[1:]):.0f} tokens/s; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; a share {moved:.4f} of "
        f"wq[0] moved; peak {gib(peak)}")

    card.reset_peak()
    small = reduced(cfg)
    model = L.init_params(small, card.gen(seed + 21), card.dev)
    toks = torch.randint(0, cfg.vocab, (1, 64), dtype=torch.int32,
                         generator=card.gen(seed + 22), device=card.dev)
    labels = torch.roll(toks, -1, dims=1)
    labels[:, -1] = -1
    loss, g = loss_and_grads(model, toks, labels)
    cpu = copy.deepcopy(model).cpu()
    closs, cg = loss_and_grads(cpu, toks.cpu(), labels.cpu())
    errs = [check_close("(c) first-step loss card/CPU", loss, closs)]
    errs += [check_close(f"(c) grad {k} card/CPU", g[k], cg[k]) for k in g]
    del cg
    remat = L.init_params(dataclasses.replace(small, remat=True),
                          card.gen(seed + 21), card.dev)
    remat.load_state_dict(model.state_dict())
    rloss, rg = loss_and_grads(remat, toks, labels)
    errs.append(check_close("(c) loss remat/none", rloss, loss))
    errs += [check_close(f"(c) grad {k} remat/none", rg[k], g[k])
             for k in g]
    del remat, rg
    # one make_train_step with the full-size run's AdamW: the parameters
    # and both moments after it, card against CPU.  Adam's first update,
    # lr * g / (|g| + eps), is a sign for all but the smallest g, so a
    # gradient entry near 0 that differs within the gradient tolerance
    # moves its parameter by a whole lr (3.3e-4 on `embed` at lr 3e-4).
    # Both steps therefore take the card's gradients, held to the CPU's
    # above: sum(p * g) has exactly g as its gradient.
    after = []
    for m in (model, cpu):
        dev = next(m.parameters()).device
        gd = {k: v.to(dev) for k, v in g.items()}
        st = init_state(tc, dict(m.named_parameters())).tree()
        st, _ = make_train_step(
            lambda p, _b, gd=gd: sum((p[k] * gd[k]).sum() for k in gd),
            tc)(st, None)
        after.append(st)
    for tree in ("params", "mu", "nu"):
        got = after[0]["params"] if tree == "params" else \
            after[0]["opt"][tree]
        want = after[1]["params"] if tree == "params" else \
            after[1]["opt"][tree]
        errs += [check_close(f"(c) AdamW {tree} {k} card/CPU", got[k],
                             want[k]) for k in got]
    del after, st, gd, g, cpu, model
    log(f"(c) fp32 at 2 layers, full width, seq 64: the first step's loss, "
        f"gradients and AdamW update (parameters and moments, on the "
        f"card's gradients) card = CPU, "
        f"remat on = off (max |diff| {max(errs):.3g}); peak "
        f"{gib(card.peak())}")
    return {"n_params": n_params, "init_s": init_s, "seq": seq,
            "batch": batch, "step_s": secs, "losses": losses,
            "moved_share": moved,
            "tokens_per_s": batch * seq / float(np.mean(secs[1:])),
            "peak_bytes": peak, "max_abs_err": max(errs),
            "check_peak_bytes": card.peak()}


# ---------------------------------------------------------------------------
# (d) the five smokes on the card
# ---------------------------------------------------------------------------

def leg_d(card, seed):
    import importlib

    from repro_torch.configs.lm_common import smoke_lm

    names = ("gemma2_2b", "glm4_9b", "h2o_danube_1_8b", "kimi_k2_1t_a32b",
             "qwen2_moe_a2_7b")
    secs = {}
    for name in names:
        cfg = importlib.import_module(f"repro_torch.configs.{name}").CONFIG
        _, secs[cfg.name] = card.timed(lambda: smoke_lm(cfg, card.dev))
    log(f"(d) smoke_lm on the card: " + ", ".join(
        f"{k} {v * 1e3:.0f} ms" for k, v in secs.items()))
    return {"smoke_s": secs}


LEGS = {"a": leg_a, "b": leg_b, "c": leg_c, "d": leg_d}


def run(dev, seed=1) -> dict:
    """Every leg on the card `dev`; raises on the first failed check."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = Card(dev)
    report = {}
    for leg, fn in LEGS.items():
        t0 = time.perf_counter()
        report[leg] = fn(card, seed)
        report[leg]["wall_s"] = time.perf_counter() - t0
        log(f"({leg}) leg done in {report[leg]['wall_s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    from repro_torch.core.types import resolve_device
    dev = resolve_device(None)
    t0 = time.perf_counter()
    report = run(dev, a.seed)
    report["wall_s"] = time.perf_counter() - t0
    report["device"] = torch.cuda.get_device_name(0)
    log(f"every leg passed in {report['wall_s']:.1f} s")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
