"""DeepFM's shapes and smoke, the port of `repro/configs/recsys_common.py`.

Shapes (assignment):
  train_batch     batch=65,536      train step (loss+grad+adamw)
  serve_p99       batch=512         online scoring
  serve_bulk      batch=262,144     offline scoring
  retrieval_cand  1 query x 1,000,000 candidates (batched dot, no loop)

Embedding tables: row-sharded over the whole mesh (the 33.8M x 10 table)
in the dry run's splits (`build_deepfm_dryrun`, the step traced on the
meta device over a `StackedMesh`); the port's DeepFM holds the table on
one card.
"""
from __future__ import annotations

import torch

from repro_torch.configs.common import (DryrunSpec, MeshAxes, S, abstract,
                                        apply_params, param_tree)
from repro_torch.models.common import init_generator
from repro_torch.models.recsys import deepfm as D
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step)

SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_cand=1_000_000),
}

N_USER_FIELDS = 26  # first 26 fields describe the user/context in retrieval


def build_deepfm_dryrun(cfg: D.DeepFMConfig, shape, mesh, axes: MeshAxes):
    sh = SHAPES[shape]
    dp = tuple(axes.dp)
    allax = (*dp, axes.tp)
    dev = mesh.device
    model = D.init_params(cfg, None, dev)
    params_abs = param_tree(model)
    psplit = {"table": S(allax, None), "linear": S(allax, None),
              "mlp": [S(None, None) for _ in params_abs["mlp"]],
              "bias": S()}

    if sh["kind"] == "train":
        tc = TrainConfig(optimizer=AdamWConfig())
        step = make_train_step(lambda p, b: apply_params(model, p, "loss")(
            b["idx"], b["y"]), tc)
        state_abs = abstract(init_state(tc, params_abs).tree())
        st_split = {"params": psplit,
                    "opt": {"mu": psplit, "nu": psplit, "step": S()},
                    "err": None}
        batch = {"idx": torch.empty((sh["batch"], cfg.n_fields),
                                    dtype=torch.int32, device=dev),
                 "y": torch.empty((sh["batch"],), dtype=torch.float32,
                                  device=dev)}
        return DryrunSpec(fn=step, args=(state_abs, batch),
                          in_splits=(st_split, {"idx": S(dp, None),
                                                "y": S(dp)}),
                          out_splits=(st_split, None),
                          note=f"train batch={sh['batch']}")

    if sh["kind"] == "serve":
        idx = torch.empty((sh["batch"], cfg.n_fields), dtype=torch.int32,
                          device=dev)
        big = sh["batch"] >= 512
        return DryrunSpec(fn=lambda p, i: apply_params(model, p)(i),
                          args=(params_abs, idx),
                          in_splits=(psplit, S(dp, None) if big
                                     else S(None, None)),
                          out_splits=S(dp) if big else S(),
                          note=f"serve batch={sh['batch']}")

    # retrieval: 1 user x n_cand items, candidates split over all devices
    # (padded up to a multiple of 512 so the candidate dim splits)
    n_item = cfg.n_fields - N_USER_FIELDS
    n_cand = ((sh["n_cand"] + 511) // 512) * 512
    user = torch.empty((N_USER_FIELDS,), dtype=torch.int32, device=dev)
    items = torch.empty((n_cand, n_item), dtype=torch.int32, device=dev)
    return DryrunSpec(
        fn=lambda p, u, it: apply_params(model, p, "score_candidates")(u, it),
        args=(params_abs, user, items),
        in_splits=(psplit, S(None), S(allax, None)),
        out_splits=S(allax),
        note=f"retrieval n_cand={sh['n_cand']}")


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
