"""The LM data stream (the port of `repro.data`)."""
from repro_torch.data.pipeline import synthetic_lm_batches, shard_batch
