from .histogram import HistogramObserver, HistogramObserverState
from .minmax import (MinMaxObserver, MovingAverageMinMaxObserver, MSEObserver, ObserverState,
                     PercentileObserver, observer_qparams)
from .quantizer import LSQQuantizer, QuantizerState, convert_shift_to_zp

__all__ = ["LSQQuantizer", "QuantizerState", "convert_shift_to_zp",
           "HistogramObserver", "HistogramObserverState", "MinMaxObserver",
           "MovingAverageMinMaxObserver", "MSEObserver", "ObserverState",
           "PercentileObserver", "observer_qparams"]
