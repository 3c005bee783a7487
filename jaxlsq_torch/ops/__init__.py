from .fake_quant import LAUNCHES, fake_quant_backward, fake_quant_forward
from .functional import fake_quant, lsq

__all__ = ["LAUNCHES", "fake_quant", "fake_quant_backward", "fake_quant_forward",
           "lsq"]
