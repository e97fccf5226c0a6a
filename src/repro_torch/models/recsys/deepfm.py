"""DeepFM [arXiv:1703.04247]: FM interaction + deep MLP over shared sparse
feature embeddings (Criteo-style: 13 dense + 26 categorical = 39 fields in
the assigned config), the port of `repro/models/recsys/deepfm.py`.

The embedding lookup is the hot path: one concatenated table, per-field row
offsets static, gathered with JAX's `jnp.take` rule (a negative id wraps,
an id past either end gives a NaN row: `sparse.segment.take_rows`).
`score_candidates` implements the retrieval_cand shape (1 query vs 10^6
candidate items) as one batched dot, not a loop.  The JAX package's
`param_shardings` (PartitionSpecs of a device mesh) has no counterpart: the
port keeps the whole table on one card.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.models.common import dense, init_generator, normal
from repro_torch.sparse.segment import take_rows

# Criteo Kaggle per-field vocabulary sizes (public DLRM preprocessing);
# fields 0..12 are dense (bucketised here), 13..38 categorical.
CRITEO_VOCABS = (
    64, 128, 128, 64, 256, 128, 64, 64, 128, 16, 32, 64, 64,   # bucketised dense
    1461, 584, 10_131_227, 2_202_608, 306, 25, 12518, 634, 4, 93146,
    5684, 8_351_593, 3195, 28, 14993, 5_461_306, 11, 5653, 2173, 4,
    7_046_547, 18, 16, 286_181, 105, 142_572,
)


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    name: str
    embed_dim: int = 10
    mlp: tuple = (400, 400, 400)
    vocabs: tuple = CRITEO_VOCABS
    interaction: str = "fm"

    @property
    def n_fields(self) -> int:
        return len(self.vocabs)

    @property
    def total_rows(self) -> int:
        # padded to a multiple of 512 so the row dim shards on any
        # production mesh (256- and 512-chip)
        raw = sum(self.vocabs)
        return ((raw + 511) // 512) * 512


def field_offsets(cfg: DeepFMConfig, device=None) -> torch.Tensor:
    """(n_fields,) int32 first table row of each field, on `device` (None
    = CUDA)."""
    off = [0]
    for v in cfg.vocabs:
        off.append(off[-1] + v)
    return torch.tensor(off[:-1], dtype=torch.int32,
                        device=resolve_device(device))


class DeepFM(nn.Module):
    def __init__(self, cfg: DeepFMConfig, generator=None, device=None):
        super().__init__()
        dev, gen = init_generator(generator, device)
        self.cfg = cfg
        d = cfg.embed_dim
        self.table = normal((cfg.total_rows, d), 0.01, gen, dev)
        self.linear = normal((cfg.total_rows, 1), 0.01, gen, dev)
        dims = [cfg.n_fields * d, *cfg.mlp, 1]
        self.mlp = nn.ParameterList([dense(i, o, gen, dev)
                                     for i, o in zip(dims[:-1], dims[1:])])
        self.bias = nn.Parameter(torch.zeros((), device=dev))
        self.register_buffer("offsets", field_offsets(cfg, dev),
                             persistent=False)

    def field_offsets(self) -> torch.Tensor:
        return self.offsets

    def forward(self, cat_idx):
        """cat_idx: (B, n_fields) per-field categorical ids (within-field).
        Returns logits (B,)."""
        rows = cat_idx + self.offsets[None, :]
        emb = take_rows(self.table, rows)                  # (B, F, d)
        lin = take_rows(self.linear, rows)[..., 0]         # (B, F)

        # FM second-order: 0.5 * ((sum v)^2 - sum v^2), summed over dim
        sv = emb.sum(dim=1)
        fm = 0.5 * (sv**2 - (emb**2).sum(dim=1)).sum(dim=-1)

        h = emb.reshape(emb.shape[0], -1)
        for i, w in enumerate(self.mlp):
            h = h @ w
            if i < len(self.mlp) - 1:
                h = torch.relu(h)
        return self.bias + lin.sum(dim=1) + fm + h[:, 0]

    def loss(self, cat_idx, labels):
        """`loss_fn`: the mean logistic loss of the logits."""
        logits = self.forward(cat_idx)
        return torch.mean(
            torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))

    def score_candidates(self, user_idx, item_idx):
        """Retrieval scoring: one user (n_user_fields,) against (N,
        n_item_fields) candidates via factored FM cross terms -- O(N d), a
        batched dot."""
        offs = self.offsets
        nu = user_idx.shape[0]
        u_rows = user_idx + offs[:nu]
        i_rows = item_idx + offs[nu:nu + item_idx.shape[1]][None, :]
        ue = take_rows(self.table, u_rows)                 # (Fu, d)
        ie = take_rows(self.table, i_rows)                 # (N, Fi, d)
        ul = take_rows(self.linear, u_rows).sum()
        il = take_rows(self.linear, i_rows)[..., 0].sum(dim=-1)
        us, iv = ue.sum(dim=0), ie.sum(dim=1)
        cross = iv @ us                                    # (N,)
        fm_u = 0.5 * ((us**2 - (ue**2).sum(dim=0)).sum())
        fm_i = 0.5 * ((iv**2 - (ie**2).sum(dim=1)).sum(dim=-1))
        return self.bias + ul + il + cross + fm_u + fm_i


def init_params(cfg: DeepFMConfig, generator=None, device=None) -> DeepFM:
    """A `DeepFM` with JAX's shapes and scales, drawn from `generator` on
    `device` (None = CUDA)."""
    return DeepFM(cfg, generator, device)
