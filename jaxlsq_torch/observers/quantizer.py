"""LSQ quantizer configuration and the qparam handoff to serving.

Port of the serving-relevant part of ``jaxlsq/observers/quantizer.py``:
``convert_shift_to_zp`` and :class:`LSQQuantizer` as a configuration object
whose :meth:`LSQQuantizer.init` builds the initial (scale, shift).  The phase
state machine and the observers belong to the training path and are not here
yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..core.spec import QuantSpec

__all__ = ["LSQQuantizer", "convert_shift_to_zp"]


def convert_shift_to_zp(shift: torch.Tensor, scale: torch.Tensor,
                        spec: QuantSpec) -> torch.Tensor:
    """zero_point = round(clamp(-shift/scale, tmin, tmax)) as int32."""
    zp = torch.round(torch.clamp(-shift / scale, spec.type_min, spec.type_max))
    return zp.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class LSQQuantizer:
    """Static configuration of one LSQ/LSQ+ fake-quantizer.

    ``otype`` is 'weight' (static mean ± 3σ scale init, symmetric spec
    required) or 'activation' (``init_scale``/``init_shift``, with the shift
    overridden by the symmetric rule for symmetric specs).
    """

    spec: QuantSpec
    otype: str = "activation"
    init_mode: str = "observer"
    n_batches: int = 1000
    init_scale: float = 1.0
    init_shift: float = 0.0
    learn_params: bool = True

    def __post_init__(self):
        if self.otype not in ("weight", "activation"):
            raise ValueError(f"otype must be 'weight' or 'activation', got {self.otype}")
        if self.init_mode not in ("observer", "learnable"):
            raise ValueError(
                f"init_mode must be 'observer' or 'learnable', got {self.init_mode}")
        if self.otype == "weight" and not self.spec.symmetric:
            raise ValueError("weight quantizers must use a symmetric spec")

    @property
    def effective_init_shift(self) -> float:
        if self.spec.symmetric:
            return self.spec.symmetric_init_shift(self.init_scale)
        return self.init_shift

    def init(self, x: Optional[torch.Tensor] = None, *,
             num_channels: Optional[int] = None,
             device=None) -> Dict[str, torch.Tensor]:
        """Initial ``{"scale", "shift"}`` (each (C,) f32).  For weights, ``x``
        drives the static init ``max(|µ−3σ|, |µ+3σ|) / 2**bitness`` with
        Bessel-corrected σ and ``bitness = ceil(log2(qmax−qmin)) − 1``."""
        if not self.spec.per_channel:
            c = 1
        elif x is not None:
            c = x.shape[self.spec.axis]
        elif num_channels is not None:
            c = num_channels
        else:
            raise ValueError("per-channel quantizer init needs x or num_channels")
        if device is None:
            device = x.device if x is not None else torch.device("cpu")
        scale = torch.full((c,), self.init_scale, dtype=torch.float32, device=device)
        if self.otype == "weight" and x is not None:
            xd = x.detach().to(torch.float32)
            bitness = math.ceil(
                math.log2(self.spec.quant_max - self.spec.quant_min)) - 1
            if self.spec.per_channel:
                red = tuple(a for a in range(x.dim()) if a != self.spec.axis)
                mean = xd.mean(dim=red)
                std = xd.std(dim=red, correction=1)
            else:
                mean = xd.mean().reshape(1)
                std = xd.std(correction=1).reshape(1)
            scale = torch.maximum((mean - 3 * std).abs(),
                                  (mean + 3 * std).abs()) / 2 ** bitness
        shift = torch.full((c,), self.effective_init_shift, dtype=torch.float32,
                           device=device)
        return {"scale": scale, "shift": shift}
