"""glm4-9b [hf:THUDM/glm-4-9b]: 40L d_model=4096 32H (GQA kv=2)
d_ff=13696 vocab=151552, RoPE with partial rotary factor 0.5.
long_500k skipped (pure full attention)."""
import torch

from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="glm4-9b", n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_head=128, d_ff=13696, vocab=151552, rope_theta=1e4, rope_fraction=0.5,
    dtype=torch.bfloat16)

SKIP_SHAPES = {"long_500k": "pure full attention at every layer"}
