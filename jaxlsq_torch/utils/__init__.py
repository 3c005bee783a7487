"""jaxlsq_torch.utils: BatchNorm re-estimation, checkpoints, profiling hooks,
torchlsq migration, quantizer and serving-size reports, sensitivity and
mixed-precision planning (port of ``jaxlsq/utils``)."""

from .bn import reestimate_batch_stats
from .checkpoint import latest_step, restore_checkpoint, restore_or_init, save_checkpoint
from .migrate import load_torchlsq_state
from .mixed_precision import format_plan, plan_mixed_precision, requantize_qconfig
from .profiling import StepTimer, annotate, trace
from .report import format_report, quantizer_report, serving_size_report
from .sensitivity import (format_sensitivity, quantizer_scopes, sensitivity_report,
                          set_fake_quant_by_scope)

__all__ = [
    "reestimate_batch_stats",
    "latest_step", "restore_checkpoint", "restore_or_init", "save_checkpoint",
    "StepTimer", "annotate", "trace",
    "load_torchlsq_state",
    "format_report", "quantizer_report", "serving_size_report",
    "sensitivity_report", "format_sensitivity", "quantizer_scopes",
    "set_fake_quant_by_scope",
    "plan_mixed_precision", "format_plan", "requantize_qconfig",
]
