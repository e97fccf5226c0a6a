"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d_model=2048 16H
(GQA kv=16) d_ff(expert)=1408 vocab=151936, 60 routed top-4 + 4 shared.
long_500k skipped (pure full attention)."""
import torch

from repro_torch.models.lm import LMConfig, MoESettings

CONFIG = LMConfig(
    name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=16, d_head=128, d_ff=1408, vocab=151936, rope_theta=1e6,
    moe=MoESettings(n_experts=60, top_k=4, d_ff_expert=1408, n_shared=4,
                    n_experts_padded=64),  # EP divisibility on 16-wide axis
    dtype=torch.bfloat16)

SKIP_SHAPES = {"long_500k": "pure full attention at every layer"}
