from .train import cross_entropy_loss, make_eval_step, make_train_step

__all__ = ["cross_entropy_loss", "make_eval_step", "make_train_step"]
