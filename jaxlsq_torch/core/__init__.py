from .golden import (broadcast_qparams, clamp_scale, effective_grad_scale,
                     golden_backward, golden_backward_traced, golden_forward,
                     golden_forward_traced)
from .spec import DTYPE_RANGES, QuantSpec, int_dtype_range

__all__ = ["QuantSpec", "int_dtype_range", "DTYPE_RANGES", "clamp_scale", "broadcast_qparams",
           "effective_grad_scale", "golden_forward", "golden_backward",
           "golden_forward_traced", "golden_backward_traced"]
