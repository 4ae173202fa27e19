"""Serving: slot-based continuous batching over the model forward.  The
training loop (`Trainer`, `make_train_step`) is ROADMAP queue 1
item 3."""
from .serving import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
