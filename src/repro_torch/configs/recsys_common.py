"""DeepFM's shapes and smoke, the port of `repro/configs/recsys_common.py`.

Shapes (assignment):
  train_batch     batch=65,536      train step (loss+grad+adamw)
  serve_p99       batch=512         online scoring
  serve_bulk      batch=262,144     offline scoring
  retrieval_cand  1 query x 1,000,000 candidates (batched dot, no loop)

The JAX module's `build_deepfm_dryrun` row-shards the 33.8M x 10 table over
a device mesh; its counterpart comes with the port's dry run (ROADMAP A16
part 2).  The port holds the table on one card.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import init_generator
from repro_torch.models.recsys import deepfm as D

SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_cand=1_000_000),
}

N_USER_FIELDS = 26  # first 26 fields describe the user/context in retrieval


def smoke_deepfm(device=None):
    dev, gen = init_generator(None, device)
    cfg = D.DeepFMConfig(name="deepfm-smoke", embed_dim=4, mlp=(16, 16),
                         vocabs=(8, 16, 32, 8))
    model = D.init_params(cfg, gen, dev)
    idx = torch.randint(0, 8, (8, 4), generator=gen, device=dev)
    y = (torch.rand((8,), generator=gen, device=dev) > 0.5).float()
    loss = model.loss(idx, y)
    loss.backward()
    grads_ok = all(bool(torch.isfinite(p.grad).all())
                   for p in model.parameters())
    if not (bool(torch.isfinite(loss)) and grads_ok):
        raise AssertionError("smoke failed: DeepFM loss or gradients")
    s = model.score_candidates(
        torch.tensor([1, 2], dtype=torch.int32, device=dev),
        torch.randint(0, 8, (50, 2), generator=gen, device=dev))
    if not (s.shape == (50,) and bool(torch.isfinite(s).all())):
        raise AssertionError("smoke failed: DeepFM candidate scores")
