"""The fault-tolerant training loop."""

from repro_torch.train.loop import (StragglerError, TrainConfig, Trainer,
                                    make_train_step)

__all__ = ["StragglerError", "TrainConfig", "Trainer", "make_train_step"]
