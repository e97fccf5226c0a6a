"""What the port's models share: the device and generator of their random
initialisation, and the (in, out) weights the JAX package applies as
`x @ w`.  Parameter names follow the JAX parameter tree's paths
(`layers.0.w_self`, `mlp.2`), so `convert.load_jax_params` copies a JAX
tree into a module leaf for leaf."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.types import resolve_device


def init_generator(generator, device) -> tuple:
    """(device, generator): `device` resolved (None = CUDA, raising
    without a card); `generator` a torch.Generator on it (None: one seeded
    with 0).  On the meta device (the dry run's shapes without storage)
    there is no generator and no draw: the generator is None."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return dev, None
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return dev, generator


def randn(shape, generator, device) -> torch.Tensor:
    """N(0, 1) fp32 draws from `generator`; on the meta device only the
    shape."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=generator, device=device)


def normal(shape, scale, generator, device) -> nn.Parameter:
    """An fp32 parameter of N(0, 1) draws times `scale`."""
    return nn.Parameter(randn(shape, generator, device) * scale)


def dense(i: int, o: int, generator, device, scale=None) -> nn.Parameter:
    """An (i, o) weight, N(0, 1) / sqrt(i) unless `scale` is given."""
    return normal((i, o), scale if scale else i ** -0.5, generator, device)


def mlp(sizes, generator, device) -> nn.ParameterList:
    """The JAX package's `_mlp`: one (i, o) weight a layer, / sqrt(i)."""
    return nn.ParameterList([dense(i, o, generator, device)
                             for i, o in zip(sizes[:-1], sizes[1:])])


def apply_mlp(ws, x):
    """The JAX package's `_apply_mlp`: x @ w a layer, silu between."""
    for i, w in enumerate(ws):
        x = x @ w
        if i < len(ws) - 1:
            x = torch.nn.functional.silu(x)
    return x


def cross_entropy(logits, labels, label_mask=None):
    """Mean of logsumexp - the label's logit (over the masked rows)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    nll = lse - ll
    if label_mask is not None:
        return torch.sum(torch.where(label_mask, nll, 0.0)) / torch.clamp(
            label_mask.sum(), min=1)
    return nll.mean()
