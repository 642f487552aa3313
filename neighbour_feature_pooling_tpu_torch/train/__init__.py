"""Training: the engine, metrics, checkpoints and the trainer."""

from .checkpoint import (  # noqa: F401
    checkpoint_exists,
    restore_checkpoint,
    restore_for_inference,
    save_checkpoint,
)
from .engine import (  # noqa: F401
    TrainState,
    create_train_state,
    cross_entropy_loss,
    eval_step,
    freeze_mask,
    train_step,
)
from .metrics import (  # noqa: F401
    confusion_matrix_update,
    init_confusion,
    metrics_from_confusion,
)
from .trainer import Trainer, TrainerConfig  # noqa: F401
