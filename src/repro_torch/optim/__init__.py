"""AdamW and gradient compression (the port of `repro.optim`)."""
from repro_torch.optim.adamw import adamw_init, adamw_update, AdamWConfig
from repro_torch.optim.grad_compress import (topk_compress_init,
                                             topk_compress, int8_compress,
                                             int8_decompress)
