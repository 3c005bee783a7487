from .fake_quant import (LAUNCHES, fake_quant_backward, fake_quant_backward_traced,
                         fake_quant_forward, fake_quant_forward_traced,
                         fake_quant_fwdbwd)
from .functional import fake_quant, fake_quant_traced, lsq

__all__ = ["LAUNCHES", "fake_quant", "fake_quant_traced", "fake_quant_backward",
           "fake_quant_forward", "fake_quant_backward_traced",
           "fake_quant_forward_traced", "fake_quant_fwdbwd", "lsq"]
