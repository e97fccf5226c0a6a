"""deepfm [arXiv:1703.04247]: 39 sparse fields, embed_dim=10,
MLP 400-400-400, FM interaction; Criteo-style vocabularies (~33.8M rows)."""
from repro_torch.models.recsys.deepfm import DeepFMConfig

CONFIG = DeepFMConfig(name="deepfm", embed_dim=10, mlp=(400, 400, 400))
SKIP_SHAPES = {}
