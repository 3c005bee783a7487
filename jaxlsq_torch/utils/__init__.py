from .bn import reestimate_batch_stats

__all__ = ["reestimate_batch_stats"]
