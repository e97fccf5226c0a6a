"""Segment ops, EmbeddingBag and the neighbour sampler (the port of
`repro.sparse`)."""
from repro_torch.sparse.segment import (segment_sum, segment_mean,
                                        segment_max, gather_scatter,
                                        degree_norm)
from repro_torch.sparse.embedding_bag import embedding_bag
from repro_torch.sparse.sampler import NeighborSampler
