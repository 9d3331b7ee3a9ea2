from repro_torch.train.trainer import Trainer, TrainConfig, make_train_step
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.resilience import (StragglerMonitor, Heartbeat,
                                          PreemptionGuard)

__all__ = ["Trainer", "TrainConfig", "make_train_step", "CheckpointManager",
           "StragglerMonitor", "Heartbeat", "PreemptionGuard"]
