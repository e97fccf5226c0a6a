"""h2o-danube-1.8b [arXiv:2401.16818; hf]: 24L d_model=2560 32H (GQA kv=8)
d_ff=6912 vocab=32000; llama+mistral mix with sliding-window attention
(window 4096 on every layer) -> ring-buffer KV cache, runs long_500k."""
import torch

from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="h2o-danube-1.8b", n_layers=24, d_model=2560, n_heads=32,
    n_kv_heads=8, d_head=80, d_ff=6912, vocab=32000, rope_theta=1e4,
    window_pattern=(4096,), dtype=torch.bfloat16)

SKIP_SHAPES = {}
