"""Training (counterpart of ``bignn_tpu/train``): the full-graph and the
hierarchical minibatch trainers, metrics and checkpoints."""

from bignn_tpu_torch.config import TrainConfig
from bignn_tpu_torch.train.checkpoint import CheckpointManager
from bignn_tpu_torch.train.metrics import (
    average_precision,
    average_precision_torch,
    roc_auc,
    roc_auc_torch,
)
from bignn_tpu_torch.train.trainer import (
    MinibatchTrainer,
    Trainer,
    make_optimizer,
)

__all__ = [
    "CheckpointManager",
    "MinibatchTrainer",
    "TrainConfig",
    "Trainer",
    "average_precision",
    "average_precision_torch",
    "make_optimizer",
    "roc_auc",
    "roc_auc_torch",
]
