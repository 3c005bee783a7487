from .golden import broadcast_qparams, clamp_scale, golden_forward
from .spec import QuantSpec, int_dtype_range

__all__ = ["QuantSpec", "int_dtype_range", "clamp_scale",
           "broadcast_qparams", "golden_forward"]
