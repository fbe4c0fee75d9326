"""Training: the train step, the fault-tolerant trainer and stage-1 router
training (ports of ``repro.train``)."""
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig, run_with_restarts

__all__ = ["TrainConfig", "init_train_state", "make_train_step", "Trainer",
           "TrainerConfig", "run_with_restarts"]
