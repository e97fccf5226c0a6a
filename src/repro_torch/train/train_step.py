"""Generic train step: loss -> grad -> AdamW, the port of
`repro/train/train_step.py`, with

  * gradient accumulation over microbatches (a loop over the leading
    microbatch axis where JAX scans it; fp32 sums divided by the count),
  * remat handled inside each model (cfg.remat),
  * optional top-k gradient compression with error feedback
    (`optim/grad_compress.py`).

The model plugs in as loss_fn(params, batch) -> scalar.  `params` is a
tree of tensors (nested dicts and lists; for a module,
`dict(model.named_parameters())`) that the loss reads: the step takes the
gradient with respect to its leaves, and `adamw_update` writes the new
values into them in place.  The JAX package's `state_shardings`
(PartitionSpecs of the ZeRO-1 optimizer state) has no counterpart: the
port holds the state on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     tree_leaves, tree_map)
from repro_torch.optim.grad_compress import topk_compress, topk_compress_init


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    compress_frac: Optional[float] = None   # e.g. 0.01 -> top-1% + EF


@dataclasses.dataclass
class TrainState:
    params: dict
    opt: dict
    err: Optional[dict] = None

    def tree(self):
        """The state as a dict of its trees, the tensors themselves (not
        copies: the step updates them in place)."""
        return {"params": self.params, "opt": self.opt, "err": self.err}


def init_state(cfg: TrainConfig, params) -> TrainState:
    err = topk_compress_init(params) if cfg.compress_frac else None
    return TrainState(params=params, opt=adamw_init(params), err=err)


def _value_and_grad(loss_fn, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_()
    loss = loss_fn(params, batch)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(loss_fn: Callable, cfg: TrainConfig):
    """loss_fn(params, batch) -> scalar.  batch leaves have a leading
    microbatch axis when cfg.microbatches > 1."""

    def step(state: dict, batch):
        params, opt, err = state["params"], state["opt"], state["err"]

        if cfg.microbatches > 1:
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(cfg.microbatches):
                mb = tree_map(lambda b: b[i], batch)
                l, g = _value_and_grad(loss_fn, params, mb)
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / cfg.microbatches
            grads = tree_map(lambda g: g / cfg.microbatches, grads)
        else:
            loss, grads = _value_and_grad(loss_fn, params, batch)

        if cfg.compress_frac:
            comp, err, densify = topk_compress(grads, err,
                                               frac=cfg.compress_frac)
            grads = densify(comp, params)

        params, opt, info = adamw_update(cfg.optimizer, params, grads, opt)
        info["loss"] = loss
        return {"params": params, "opt": opt, "err": err}, info

    return step
