from .fsdp import fsdp_sharding
from .mesh import data_sharding, initialize_distributed, make_mesh, replicated, shard_batch
from .moe import EXPERT_SCOPES, moe_sharding
from .optim import QATOptimizer, project_scale_floor, qat_optimizer
from .pipeline import (PipelineStage, create_pipeline_state, gather_pipeline_model,
                       make_pipeline_train_step, pipeline_mesh, pipeline_sharding,
                       stack_pipeline_variables, unstack_pipeline_variables)
from .placement import apply_sharding
from .train import cross_entropy_loss, distillation_loss, make_eval_step, make_train_step

__all__ = ["cross_entropy_loss", "distillation_loss", "make_eval_step", "make_train_step",
           "QATOptimizer", "project_scale_floor", "qat_optimizer",
           "make_mesh", "data_sharding", "replicated", "shard_batch",
           "initialize_distributed", "fsdp_sharding", "moe_sharding",
           "EXPERT_SCOPES", "apply_sharding",
           "pipeline_mesh", "stack_pipeline_variables", "unstack_pipeline_variables",
           "pipeline_sharding", "create_pipeline_state", "make_pipeline_train_step",
           "PipelineStage", "gather_pipeline_model"]
