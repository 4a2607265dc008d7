"""Training: the one-device trainer, host data and the request wire."""
from rec_now_tpu_torch.training.data import Batch, SyntheticCriteo  # noqa: F401
from rec_now_tpu_torch.training.trainer import (  # noqa: F401
    Trainer, TrainerConfig, TrainState)
