"""gemma2-2b [arXiv:2408.00118; hf]: 26L d_model=2304 8H (GQA kv=4)
d_ff=9216 vocab=256000; alternating local(4096)/global attention, attn
softcap 50, final-logit softcap 30, sandwich norms, tied embeddings,
query scale 1/sqrt(256).  Runs long_500k (hybrid local/global)."""
import torch

from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="gemma2-2b", n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
    d_head=256, d_ff=9216, vocab=256000, rope_theta=1e4,
    attn_softcap=50.0, logit_softcap=30.0, query_scale=256**-0.5,
    window_pattern=(4096, 0), post_norms=True, tie_embeddings=True,
    dtype=torch.bfloat16)

SKIP_SHAPES = {}
