"""Training and serving: the training loop (`Trainer`, `TrainerConfig`,
`make_train_step`, a differentiable step through the attention kernels'
backward on CUDA) and slot-based continuous batching over the model
forward (`ServeEngine`, `Request`)."""
from .loop import Trainer, TrainerConfig, make_train_step
from .serving import Request, ServeEngine

__all__ = ["Trainer", "TrainerConfig", "make_train_step", "Request",
           "ServeEngine"]
