"""Training driver CLI, the port of `repro/launch/train.py`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --steps 50 [--reduced] [--ckpt-dir ckpts] [--device cpu] [--seed 0]

It runs on the card unless `--device` names another (without a card and
without `--device cpu` it raises).  Like the JAX driver it trains the
reduced config of `--arch` (2 layers, d_model 128, vocab 512, fp32) and
wires the full stack: config -> params -> train step -> data pipeline ->
fault-tolerant runner (`StepRunner`, `RetryPolicy`) -> checkpoints (every
25 steps, the last 2 kept).  `--seed` seeds the weights' generator (the
data's stream is the JAX driver's, seed 0).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="ckpts")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import importlib

    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core.types import resolve_device
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.models import lm as L
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import RetryPolicy, StepRunner
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.train_step import init_state

    mod = importlib.import_module(
        "repro_torch.configs." + args.arch.replace("-", "_").replace(".", "_"))
    full = mod.CONFIG
    cfg = L.LMConfig(
        name=full.name + "-reduced", n_layers=2, d_model=128,
        n_heads=min(4, full.n_heads), n_kv_heads=min(2, full.n_kv_heads),
        d_head=32, d_ff=256, vocab=512,
        attn_softcap=full.attn_softcap, logit_softcap=full.logit_softcap,
        window_pattern=tuple(min(w, 32) for w in full.window_pattern),
        post_norms=full.post_norms, tie_embeddings=full.tie_embeddings,
        moe=None if full.moe is None else L.MoESettings(8, 2, 64, 1),
        dtype=torch.float32, remat=False)

    dev = resolve_device(args.device)
    model = L.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    tc = TrainConfig(optimizer=AdamWConfig(lr=3e-4, warmup_steps=10,
                                           total_steps=args.steps))
    step = make_train_step(lambda p, b: model.loss(b[0], b[1]), tc)
    state = init_state(tc, dict(model.named_parameters())).tree()
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    runner = StepRunner(step, policy=RetryPolicy(), ckpt=ckpt, ckpt_every=25)

    data = ((torch.as_tensor(t, device=dev), torch.as_tensor(l, device=dev))
            for t, l in synthetic_lm_batches(cfg.vocab, args.batch, args.seq,
                                             n_batches=args.steps))
    for i, batch in enumerate(data):
        state, (info,) = runner.run(state, [batch], start_step=i)
        if i % 10 == 0:
            print(f"step {i:4d} loss={float(info['loss']):.4f}")
    print("done; checkpoints in", args.ckpt_dir)


if __name__ == "__main__":
    main()
