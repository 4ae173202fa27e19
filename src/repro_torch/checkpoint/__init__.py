from .ckpt import (latest_step, prune_checkpoints, restore_checkpoint,
                   save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "prune_checkpoints"]
