"""End-to-end LM training on the PyTorch port: a reduced gemma2-style model
on the synthetic token pipeline for a few hundred steps, with
checkpointing and the fault-tolerant step runner (the twin of
examples/train_lm.py).  Loss must drop (the pipeline has learnable copy
structure).

    python scripts/torch_train_lm.py [steps] [--full-100m]
                                     [--device cuda|cpu] [--seed 0]
                                     [--ckpt-dir ckpt_train_lm]

It runs on --device (the card by default; without one pass --device cpu),
the weights drawn from a torch generator seeded with --seed.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.core.types import resolve_device  # noqa: E402
from repro_torch.data import synthetic_lm_batches  # noqa: E402
from repro_torch.models import lm as L  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime import RetryPolicy, StepRunner  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402
from repro_torch.train.train_step import init_state  # noqa: E402


def main(steps=200, full=False, device=None, seed=0,
         ckpt_dir="ckpt_train_lm"):
    dev = resolve_device(device)
    if full:  # ~100M params (for real hardware; slow on 1 CPU core)
        cfg = L.LMConfig(name="train-100m", n_layers=12, d_model=768,
                         n_heads=12, n_kv_heads=4, d_head=64, d_ff=2048,
                         vocab=32000, window_pattern=(1024, 0),
                         tie_embeddings=True, dtype=torch.float32,
                         remat=False)
        batch, seq = 8, 512
    else:
        cfg = L.LMConfig(name="train-mini", n_layers=4, d_model=256,
                         n_heads=8, n_kv_heads=4, d_head=32, d_ff=1024,
                         vocab=512, window_pattern=(64, 0),
                         tie_embeddings=True, dtype=torch.float32,
                         remat=False)
        batch, seq = 16, 128
    n_params = cfg.param_count()
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params, "
          f"batch={batch} seq={seq}, {steps} steps on {dev}")

    model = L.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                          dev)
    tc = TrainConfig(optimizer=AdamWConfig(lr=3e-4, warmup_steps=20,
                                           total_steps=steps))
    step = make_train_step(lambda p, b: model.loss(b[0], b[1]), tc)
    state = init_state(tc, dict(model.named_parameters())).tree()

    ckpt = CheckpointManager(ckpt_dir, keep=2)
    runner = StepRunner(step, policy=RetryPolicy(), ckpt=ckpt, ckpt_every=100)

    data = synthetic_lm_batches(cfg.vocab, batch, seq, n_batches=steps)
    losses = []
    t0 = time.time()
    for i, (toks, labels) in enumerate(data):
        batch_t = (torch.as_tensor(toks, device=dev),
                   torch.as_tensor(labels, device=dev))
        state, (info,) = runner.run(state, [batch_t], start_step=i)
        if i % 20 == 0 or i == steps - 1:
            l = float(info["loss"])
            losses.append(l)
            print(f"step {i:4d} loss={l:.4f} "
                  f"gnorm={float(info['grad_norm']):.3f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'IMPROVED' if losses[-1] < losses[0] - 0.2 else 'check config'})")
    return losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", type=int, nargs="?", default=200)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="ckpt_train_lm")
    a = ap.parse_args()
    main(a.steps, a.full_100m, a.device, a.seed, a.ckpt_dir)
