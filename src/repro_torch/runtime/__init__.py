"""Fault tolerance: retry / straggler harness, mid-traversal recovery,
checkpoints and the elastic shrink (the port of `repro/runtime`)."""
from repro_torch.runtime.fault import RetryPolicy, StepRunner, \
    StragglerWatchdog, FaultInjector
from repro_torch.runtime.recovery import (DeviceLoss, DeviceLossInjector,
                                          ElasticCoordinator, RecoveryPlan,
                                          TraversalCheckpointer,
                                          UnrecoverableLoss, run_segmented)
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.ckpt.elastic import reshard_state, shrink_grid
