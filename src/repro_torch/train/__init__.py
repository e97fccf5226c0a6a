"""The train and serve steps (the port of `repro.train`)."""
from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                          TrainState)
from repro_torch.train.serve_step import make_serve_step
