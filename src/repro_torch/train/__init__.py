from .steps import loss_fn, make_train_step, make_eval_step
from .loop import Trainer, TrainConfig

__all__ = ["loss_fn", "make_train_step", "make_eval_step", "Trainer", "TrainConfig"]
