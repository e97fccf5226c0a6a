"""kimi-k2-1t-a32b [arXiv:2501.kimi2; unverified]: 61L d_model=7168 64H
(GQA kv=8) d_ff(expert)=2048 vocab=163840, MoE 384 experts top-8 (+1 shared).
Trillion-parameter MoE; long_500k skipped (pure full attention)."""
import torch

from repro_torch.models.lm import LMConfig, MoESettings

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
    n_kv_heads=8, d_head=128, d_ff=2048, vocab=163840, rope_theta=5e4,
    moe=MoESettings(n_experts=384, top_k=8, d_ff_expert=2048, n_shared=1),
    dtype=torch.bfloat16)

SKIP_SHAPES = {"long_500k": "pure full attention at every layer (524k-token "
                            "decode assigned only to sub-quadratic archs)"}
