from .bn import reestimate_batch_stats
from .checkpoint import latest_step, restore_checkpoint, restore_or_init, save_checkpoint

__all__ = ["reestimate_batch_stats", "save_checkpoint", "restore_checkpoint", "latest_step",
           "restore_or_init"]
