from .optim import QATOptimizer, project_scale_floor, qat_optimizer
from .train import cross_entropy_loss, distillation_loss, make_eval_step, make_train_step

__all__ = ["cross_entropy_loss", "distillation_loss", "make_eval_step", "make_train_step",
           "QATOptimizer", "project_scale_floor", "qat_optimizer"]
