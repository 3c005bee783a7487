"""Min/max range observers for activation-quantizer initialization (port of
``ObserverState``, ``MinMaxObserver``, ``MovingAverageMinMaxObserver`` and
``observer_qparams`` of ``jaxlsq/observers/minmax.py``).

The tracked range and ``seen`` (the update count, int32, whose first value
makes the update overwrite) stay on the device, and the update chooses
between overwrite and average with ``torch.where``, as the JAX package does:
no host read, and no host branch in a captured step.  MSE, percentile and
histogram observers come later.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.spec import QuantSpec

__all__ = ["ObserverState", "MinMaxObserver", "MovingAverageMinMaxObserver",
           "observer_qparams"]


@dataclasses.dataclass(frozen=True)
class ObserverState:
    """Tracked range, (1,) per tensor or (C,) per channel, and the update
    count, a () int32 tensor on the same device."""

    min_val: torch.Tensor
    max_val: torch.Tensor
    seen: torch.Tensor

    def replace(self, **kw) -> "ObserverState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MinMaxObserver:
    """Running min/max (``averaging_constant=None``) or its exponential
    moving average ``min <- min + c * (batch_min - min)``."""

    per_channel: bool = False
    axis: int = 1
    averaging_constant: Optional[float] = None

    def init(self, num_channels: int = 1, device=None) -> ObserverState:
        c = num_channels if self.per_channel else 1
        return ObserverState(torch.zeros(c, device=device),
                             torch.zeros(c, device=device),
                             torch.zeros((), dtype=torch.int32, device=device))

    def _batch_min_max(self, x: torch.Tensor):
        x = x.detach().to(torch.float32)
        if self.per_channel:
            axis = self.axis % x.dim()
            xt = x.movedim(axis, 0).reshape(x.shape[axis], -1)
            return xt.amin(dim=1), xt.amax(dim=1)
        return x.amin().reshape(1), x.amax().reshape(1)

    def update(self, state: ObserverState, x: torch.Tensor) -> ObserverState:
        bmin, bmax = self._batch_min_max(x)
        first = state.seen == 0
        if self.averaging_constant is None:
            new_min = torch.where(first, bmin, torch.minimum(state.min_val, bmin))
            new_max = torch.where(first, bmax, torch.maximum(state.max_val, bmax))
        else:
            c = self.averaging_constant
            new_min = torch.where(first, bmin, state.min_val + c * (bmin - state.min_val))
            new_max = torch.where(first, bmax, state.max_val + c * (bmax - state.max_val))
        return ObserverState(new_min, new_max, state.seen + 1)

    def calculate_qparams(self, state: ObserverState,
                          spec: QuantSpec) -> Tuple[torch.Tensor, torch.Tensor]:
        return observer_qparams(state.min_val, state.max_val, spec)


def MovingAverageMinMaxObserver(averaging_constant: float = 0.01,
                                per_channel: bool = False,
                                axis: int = 1) -> MinMaxObserver:
    """torch ``MovingAverage(PerChannel)MinMaxObserver`` equivalent."""
    return MinMaxObserver(per_channel=per_channel, axis=axis,
                          averaging_constant=averaging_constant)


def observer_qparams(min_val: torch.Tensor, max_val: torch.Tensor,
                     spec: QuantSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch-compatible ``(scale, zero_point)`` (both float) from a tracked
    range: affine ``scale = (max+ - min-) / (qmax - qmin)``, ``zp = clamp(qmin
    - round(min- / scale))``; symmetric ``scale = max(-min-, max+) / ((qmax -
    qmin) / 2)`` with zp 0 for a signed range, else the range's midpoint;
    scale floored at the f32 eps."""
    qmin, qmax = float(spec.quant_min), float(spec.quant_max)
    eps = torch.finfo(torch.float32).eps
    min_neg = torch.clamp_max(min_val, 0.0)
    max_pos = torch.clamp_min(max_val, 0.0)
    if spec.symmetric:
        amax = torch.maximum(-min_neg, max_pos)
        scale = torch.clamp_min(amax / ((qmax - qmin) / 2.0), eps)
        if spec.quant_min <= 0 <= spec.quant_max and spec.quant_min < 0:
            zp = torch.zeros_like(scale)
        else:
            zp = torch.full_like(scale, float((spec.quant_min + spec.quant_max + 1) // 2))
    else:
        scale = torch.clamp_min((max_pos - min_neg) / (qmax - qmin), eps)
        zp = torch.clamp(qmin - torch.round(min_neg / scale), qmin, qmax)
    return scale, zp
