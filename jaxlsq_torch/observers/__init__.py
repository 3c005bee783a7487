from .minmax import (MinMaxObserver, MovingAverageMinMaxObserver, ObserverState,
                     observer_qparams)
from .quantizer import LSQQuantizer, QuantizerState, convert_shift_to_zp

__all__ = ["LSQQuantizer", "QuantizerState", "convert_shift_to_zp",
           "MinMaxObserver", "MovingAverageMinMaxObserver", "ObserverState",
           "observer_qparams"]
