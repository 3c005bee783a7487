"""Histogram range observer (port of ``jaxlsq/observers/histogram.py``,
torch.ao's ``HistogramObserver`` semantics), per tensor only.

* ``update(state, x)`` keeps a ``bins``-bin histogram over the union range
  of every batch seen: the batch's histc over the new range plus the old
  histogram remapped into the new grid (torch's ``_combine_histograms`` /
  ``_upscale_histogram``, its eager branches as where-merges), in
  ``ops.observers.hist_update``.
* ``calculate_qparams(state, spec)`` runs torch's
  ``_non_linear_param_search`` (``ops.observers.hist_search``) and maps the
  chosen range to (scale, zero_point) with ``observer_qparams``; a fresh
  observer gives (1.0, 0).

On the card both are kernels that read the traced regime's gate (the
quantizer's ``observer_enabled``) and do nothing when it is off; the batch's
min and max and the merges around them are PyTorch ops.  On the CPU both are
the plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import _dist
from ..core.spec import QuantSpec
from .minmax import observer_qparams

__all__ = ["HistogramObserver", "HistogramObserverState"]


@dataclasses.dataclass(frozen=True)
class HistogramObserverState:
    """The union range, (1,) each as ``ObserverState``'s, the (bins,) f32
    histogram over it, and the () int32 update count."""

    min_val: torch.Tensor
    max_val: torch.Tensor
    histogram: torch.Tensor
    seen: torch.Tensor

    def replace(self, **kw) -> "HistogramObserverState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class HistogramObserver:
    """torch.ao ``HistogramObserver`` equivalent (per tensor only)."""

    bins: int = 2048
    upsample_rate: int = 16

    # a histogram update and a while-loop search an update: the traced regime
    # gates both on the card
    expensive_update = True

    def init(self, num_channels: int = 1, device=None) -> HistogramObserverState:
        if num_channels != 1:
            raise ValueError(
                "HistogramObserver is per-tensor only (torch parity: it rejects "
                f"per-channel qschemes); got num_channels={num_channels}")
        return HistogramObserverState(
            min_val=torch.zeros(1, device=device), max_val=torch.zeros(1, device=device),
            histogram=torch.zeros(self.bins, device=device),
            seen=torch.zeros((), dtype=torch.int32, device=device))

    def update(self, state: HistogramObserverState, x: torch.Tensor,
               gate: Optional[torch.Tensor] = None) -> HistogramObserverState:
        from ..ops.observers import hist_update

        xf = x.detach().to(torch.float32)
        bmin, bmax = xf.amin().reshape(1), xf.amax().reshape(1)
        split = _dist.current()
        old = state.histogram
        if split is not None:
            # the global range; each process counts its rows and the first
            # also carries the old histogram into the new grid (the update
            # is linear in it), so the sum over the processes is the global
            # update
            bmin, bmax = _dist.reduce_range(bmin, bmax, split)
            if any(p.rank for p in split.parts):
                old = torch.zeros_like(old)
        first = state.seen == 0
        new_min = torch.where(first, bmin, torch.minimum(state.min_val, bmin))
        new_max = torch.where(first, bmax, torch.maximum(state.max_val, bmax))
        hist = hist_update(xf, old, state.min_val, state.max_val, new_min,
                           new_max, state.seen, self.upsample_rate, gate=gate)
        if split is not None:
            hist = _dist.reduce_sum(hist, split)
        return HistogramObserverState(new_min, new_max, hist, state.seen + 1)

    def calculate_qparams(self, state: HistogramObserverState, spec: QuantSpec,
                          gate: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        from ..ops.observers import hist_search

        # dst_nbins: the carrier's level count, as torch's 2**bits
        dst_nbins = int(spec.type_max) - int(spec.type_min) + 1
        rng = hist_search(state.histogram, state.min_val, state.max_val, dst_nbins,
                          gate=gate)
        scale, zp = observer_qparams(rng[0:1], rng[1:2], spec)
        fresh = state.seen == 0
        return (torch.where(fresh, torch.ones_like(scale), scale),
                torch.where(fresh, torch.zeros_like(zp), zp))
