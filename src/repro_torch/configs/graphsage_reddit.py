"""graphsage-reddit [arXiv:1706.02216]: 2 layers d_hidden=128 mean
aggregator, sample sizes 25-10 (training uses the shape's fanout 15-10 for
minibatch_lg, per the assignment)."""
from repro_torch.models.gnn.graphsage import SAGEConfig

CONFIG = SAGEConfig(name="graphsage-reddit", n_layers=2, d_hidden=128,
                    d_in=602, n_classes=41, aggregator="mean")
SAMPLE_SIZES = (25, 10)
SKIP_SHAPES = {}
