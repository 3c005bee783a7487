"""Range observers for activation-quantizer initialization (port of
``jaxlsq/observers/minmax.py``): ``ObserverState``, ``MinMaxObserver``,
``MovingAverageMinMaxObserver``, ``MSEObserver``, ``PercentileObserver`` and
``observer_qparams``.

The tracked range and ``seen`` (the update count, int32, whose first value
makes the update overwrite) stay on the device, and the update chooses
between overwrite and average with ``torch.where``, as the JAX package does:
no host read, and no host branch in a captured step.

The quantizer's traced regime hands every observer its
``observer_enabled`` as ``gate`` and where-merges what comes back.  The
JAX package's ``expensive_update`` split lives in the observers: the
min/max update (cheap, ``expensive_update`` False) ignores the gate and
always runs; the MSE search is the kernel ``ops.observers.mse_range``,
which reads the gate on the card and does nothing when it is off; the
percentile's sort is PyTorch ops, which always run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _dist
from ..core.spec import QuantSpec

__all__ = ["ObserverState", "MinMaxObserver", "MovingAverageMinMaxObserver",
           "MSEObserver", "PercentileObserver", "observer_qparams"]


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

    # one fusable min/max reduce: it ignores the traced regime's gate, so it
    # always runs and is where-merged
    expensive_update = False

    def init(self, num_channels: int = 1, device=None) -> ObserverState:
        return _range_state(num_channels if self.per_channel else 1, device)

    def update(self, state: ObserverState, x: torch.Tensor,
               gate: Optional[torch.Tensor] = None) -> ObserverState:
        bmin, bmax = _batch_min_max(x, self.per_channel, self.axis)
        return _merge(state, bmin, bmax, self.averaging_constant)

    def calculate_qparams(self, state: ObserverState, spec: QuantSpec,
                          gate: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        return observer_qparams(state.min_val, state.max_val, spec)


def _range_state(c: int, device) -> ObserverState:
    return ObserverState(torch.zeros(c, device=device), torch.zeros(c, device=device),
                         torch.zeros((), dtype=torch.int32, device=device))


def _channels_first(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x as (C, everything else), C the size of ``axis``."""
    axis = axis % x.dim()
    return x.movedim(axis, 0).reshape(x.shape[axis], -1)


def _batch_min_max(x: torch.Tensor, per_channel: bool, axis: int):
    """The batch's range; under a split of the rows (``_dist.current()``)
    the global one, the processes' ranges all-reduced."""
    x = x.detach().to(torch.float32)
    if per_channel:
        xt = _channels_first(x, axis)
        bmin, bmax = xt.amin(dim=1), xt.amax(dim=1)
    else:
        bmin, bmax = x.amin().reshape(1), x.amax().reshape(1)
    split = _dist.current()
    if split is not None:
        bmin, bmax = _dist.reduce_range(bmin, bmax, split)
    return bmin, bmax


def _merge(state: ObserverState, bmin: torch.Tensor, bmax: torch.Tensor,
           averaging_constant: Optional[float]) -> ObserverState:
    """The new state from a batch range: overwrite on the first update, then
    running min/max (``averaging_constant`` None) or its moving average."""
    first = state.seen == 0
    if averaging_constant is None:
        new_min = torch.where(first, bmin, torch.minimum(state.min_val, bmin))
        new_max = torch.where(first, bmax, torch.maximum(state.max_val, bmax))
    else:
        c = averaging_constant
        new_min = torch.where(first, bmin, state.min_val + c * (bmin - state.min_val))
        new_max = torch.where(first, bmax, state.max_val + c * (bmax - state.max_val))
    return ObserverState(new_min, new_max, state.seen + 1)


def MovingAverageMinMaxObserver(averaging_constant: float = 0.01,
                                per_channel: bool = False,
                                axis: int = 1) -> MinMaxObserver:
    """torch ``MovingAverage(PerChannel)MinMaxObserver`` equivalent."""
    return MinMaxObserver(per_channel=per_channel, axis=axis,
                          averaging_constant=averaging_constant)


@dataclasses.dataclass(frozen=True)
class MSEObserver:
    """MSE-minimizing range observer: each update shrinks the batch's range
    ``(bmin, bmax)`` by each factor of ``linspace(1/64, 1, 64)``, scores each
    by the squared error of fake-quantizing the batch at that range's qparams
    (``spec``, the quantizer's own; per channel when ``per_channel``), keeps
    the first least, and merges it like a moving-average min/max.  The
    search is ``ops.observers.mse_range``: one kernel launch on the card, the
    plain PyTorch version on the CPU."""

    spec: QuantSpec
    per_channel: bool = False
    axis: int = 1
    num_candidates: int = 64
    averaging_constant: Optional[float] = 0.01

    # a 64-candidate search an update: the traced regime gates it on the card
    expensive_update = True

    def init(self, num_channels: int = 1, device=None) -> ObserverState:
        return _range_state(num_channels if self.per_channel else 1, device)

    def update(self, state: ObserverState, x: torch.Tensor,
               gate: Optional[torch.Tensor] = None) -> ObserverState:
        from ..ops.observers import linspace, mse_range

        bmin, bmax = _batch_min_max(x, self.per_channel, self.axis)
        split = _dist.current()
        if split is None:
            nmin, nmax = mse_range(x, bmin, bmax, self.spec, self.per_channel,
                                   self.axis, self.num_candidates, gate=gate)
        else:
            # the candidates' errors over the local rows, summed over the
            # processes, then the first least, as on the global batch
            errs = torch.empty((bmin.numel(), self.num_candidates),
                               dtype=torch.float32, device=bmin.device)
            mse_range(x, bmin, bmax, self.spec, self.per_channel, self.axis,
                      self.num_candidates, gate=gate, errs=errs)
            errs = _dist.reduce_sum(errs, split)
            f = linspace(1.0 / self.num_candidates, 1.0, self.num_candidates)
            fb = f.to(bmin.device)[torch.argmin(errs, dim=1)]
            nmin, nmax = bmin * fb, bmax * fb
        return _merge(state, nmin, nmax, self.averaging_constant)

    def calculate_qparams(self, state: ObserverState, spec: QuantSpec,
                          gate: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        return observer_qparams(state.min_val, state.max_val, spec)


@dataclasses.dataclass(frozen=True)
class PercentileObserver:
    """Percentile range observer: tracks the batch's ``(100 - p, p)``
    percentiles (numpy's 'linear' rule) instead of its min and max, merged
    like a moving-average min/max.  ``sample_cap`` subsamples the flattened
    batch (per channel: each channel's elements) with a deterministic stride
    along the last axis before the sort, as the JAX package does; None sorts
    everything.  PyTorch ops on either device: one ``torch.sort`` of at most
    ``sample_cap`` elements (a channel's row each per channel), no host read,
    so it runs inside a captured step, always (the traced regime
    where-merges its result)."""

    percentile: float = 99.99
    per_channel: bool = False
    axis: int = 1
    averaging_constant: Optional[float] = 0.01
    sample_cap: Optional[int] = 1 << 16

    expensive_update = True

    def __post_init__(self):
        if not 50.0 < self.percentile <= 100.0:
            raise ValueError(f"percentile must be in (50, 100], got {self.percentile}")
        if self.sample_cap is not None and self.sample_cap < 1024:
            raise ValueError("sample_cap must be >= 1024 (or None for exact)")

    def init(self, num_channels: int = 1, device=None) -> ObserverState:
        return _range_state(num_channels if self.per_channel else 1, device)

    def _subsample(self, flat: torch.Tensor) -> torch.Tensor:
        n = flat.shape[-1]
        if self.sample_cap is None or n <= self.sample_cap:
            return flat
        return flat[..., ::-(-n // self.sample_cap)]

    def _batch_range(self, x: torch.Tensor):
        xf = x.detach().to(torch.float32)
        split = _dist.current()
        if split is not None:  # the sample is drawn from the global tensor
            xf = _dist.gather_global(xf, split)
        rows = _channels_first(xf, self.axis) if self.per_channel else xf.reshape(1, -1)
        rows = self._subsample(rows)
        n = rows.shape[-1]
        # q / 100 * (n - 1) and the two weights in f32, as jnp.percentile
        q = np.asarray([100.0 - self.percentile, self.percentile], np.float32)
        pos = q / np.float32(100.0) * np.float32(n - 1)
        low, high = np.floor(pos), np.ceil(pos)
        hw = pos - low
        lw = np.float32(1.0) - hw
        low = np.clip(low, 0, n - 1).astype(np.int64)
        high = np.clip(high, 0, n - 1).astype(np.int64)
        # a row holding a NaN is all NaN, as jnp.percentile's
        rows = torch.where(torch.isnan(rows).any(dim=1, keepdim=True),
                           torch.full_like(rows, float("nan")), rows)
        srt = torch.sort(rows, dim=1).values
        lo = srt[:, int(low[0])] * float(lw[0]) + srt[:, int(high[0])] * float(hw[0])
        hi = srt[:, int(low[1])] * float(lw[1]) + srt[:, int(high[1])] * float(hw[1])
        return lo, hi

    def update(self, state: ObserverState, x: torch.Tensor,
               gate: Optional[torch.Tensor] = None) -> ObserverState:
        bmin, bmax = self._batch_range(x)
        return _merge(state, bmin, bmax, self.averaging_constant)

    def calculate_qparams(self, state: ObserverState, spec: QuantSpec,
                          gate: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        return observer_qparams(state.min_val, state.max_val, spec)


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
