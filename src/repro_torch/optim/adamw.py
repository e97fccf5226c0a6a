"""AdamW with decoupled weight decay + linear-warmup cosine schedule, the
port of `repro/optim/adamw.py`.

Parameters, gradients and the optimizer state are trees of tensors (nested
dicts and lists, e.g. `dict(module.named_parameters())`); leaves are taken
in the JAX package's order (dict keys sorted, list items in turn).  The
update is JAX's formula to the letter -- global-norm clip, bias correction
with the step as float32, weight decay inside the lr term, fp32 moments --
which `torch.optim.AdamW` is not (its eps placement and bias correction
differ, and it has no global clip).  `adamw_update` writes the new
parameters and moments into their tensors in place, under `no_grad`.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, in JAX's leaf order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the same leaves of `rest`), called
    in `tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def schedule(cfg: AdamWConfig, step):
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * prog))


def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = tree_leaves(params)[0]
    return {"mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def _global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One step: (params, state, {"grad_norm", "lr"}); the parameter and
    moment tensors are updated in place and returned in their trees."""
    step = state["step"] + 1
    gn = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    c1 = 1 - cfg.b1 ** step.to(torch.float32)
    c2 = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * clip
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        p32 = p.to(torch.float32)
        newp = p32 - lr * (mu / c1 / (torch.sqrt(nu / c2) + cfg.eps)
                           + cfg.weight_decay * p32)
        p.copy_(newp.to(p.dtype))

    tree_map(upd, params, grads, state["mu"], state["nu"])
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, \
        {"grad_norm": gn, "lr": lr}
