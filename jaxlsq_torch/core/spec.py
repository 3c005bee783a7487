"""Quantization specification: the static configuration of an LSQ/LSQ+ fake-quantizer.

PyTorch-side copy of ``jaxlsq/core/spec.py`` (the JAX package's module cannot
be imported here: importing it runs ``jaxlsq/__init__.py``, which imports jax).
Field for field the same frozen dataclass:

* ``quant_min``/``quant_max`` — the quantization range used for clamping.
* ``type_min``/``type_max`` — the limits of the carrier integer type; may be
  wider than the quant range (a 7-bit range carried in int8).
* symmetric vs affine, per-tensor vs per-channel along ``axis``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = ["QuantSpec", "int_dtype_range", "DTYPE_RANGES"]

# The carrier integer types' limits, int4 and uint4 beside int8 and uint8.
DTYPE_RANGES = {
    "int8": (-128, 127),
    "uint8": (0, 255),
    "int4": (-8, 7),
    "uint4": (0, 15),
}


def int_dtype_range(bits: int, signed: bool) -> Tuple[int, int]:
    """Numeric limits of a ``bits``-wide (un)signed integer."""
    if signed:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2**bits - 1


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of one fake-quantizer (see ``jaxlsq.core.spec``)."""

    quant_min: int = 0
    quant_max: int = 255
    type_min: Optional[int] = None
    type_max: Optional[int] = None
    symmetric: bool = False
    per_channel: bool = False
    axis: int = 1
    use_grad_scaling: bool = True
    grad_scaler: float = 1.0

    def __post_init__(self):
        if self.quant_min >= self.quant_max:
            raise ValueError(
                f"quant_min ({self.quant_min}) must be < quant_max ({self.quant_max})"
            )
        if self.symmetric and not (self.quant_min <= 0 <= self.quant_max):
            raise ValueError(
                "quantization range must cover 0 in symmetric quantization"
            )
        if self.type_min is None:
            object.__setattr__(self, "type_min", self.quant_min)
        if self.type_max is None:
            object.__setattr__(self, "type_max", self.quant_max)
        if self.type_min > self.quant_min or self.type_max < self.quant_max:
            raise ValueError(
                "carrier type range must contain the quantization range: "
                f"[{self.type_min},{self.type_max}] vs [{self.quant_min},{self.quant_max}]"
            )

    @property
    def n_levels(self) -> int:
        return self.quant_max - self.quant_min + 1

    @property
    def bitness(self) -> int:
        """Effective bit width of the quant range (ceil(log2(levels)))."""
        return max(1, math.ceil(math.log2(self.n_levels)))

    def replace(self, **kw) -> "QuantSpec":
        return dataclasses.replace(self, **kw)

    @classmethod
    def make(
        cls,
        bits: int = 8,
        *,
        signed: bool = False,
        symmetric: bool = False,
        per_channel: bool = False,
        axis: int = 1,
        narrow_to_bits: Optional[int] = None,
        use_grad_scaling: bool = True,
        grad_scaler: float = 1.0,
    ) -> "QuantSpec":
        """Build a spec from a bit width; ``narrow_to_bits`` narrows the quant
        range (e.g. 7-bit inside an 8-bit carrier) while ``type_min/max`` keep
        the full carrier range."""
        tmin, tmax = int_dtype_range(bits, signed)
        if narrow_to_bits is None:
            qmin, qmax = tmin, tmax
        else:
            if narrow_to_bits > bits:
                raise ValueError("narrow_to_bits must be <= bits")
            qmin, qmax = 0, 2**narrow_to_bits - 1
            if signed:
                half = 2 ** (narrow_to_bits - 1)
                qmin, qmax = qmin - half, qmax - half
        return cls(
            quant_min=qmin,
            quant_max=qmax,
            type_min=tmin,
            type_max=tmax,
            symmetric=symmetric,
            per_channel=per_channel,
            axis=axis,
            use_grad_scaling=use_grad_scaling,
            grad_scaler=grad_scaler,
        )

    @classmethod
    def weight_default(cls, bits: int = 8, *, per_channel: bool = False, axis: int = 0,
                       reduce_range: bool = True) -> "QuantSpec":
        """qint8-style weight spec: signed symmetric, 7-bit narrowed by default."""
        return cls.make(
            bits,
            signed=True,
            symmetric=True,
            per_channel=per_channel,
            axis=axis,
            narrow_to_bits=bits - 1 if reduce_range else None,
        )

    @classmethod
    def activation_default(cls, bits: int = 8, *, per_channel: bool = False, axis: int = 1,
                           symmetric: bool = False, reduce_range: bool = True) -> "QuantSpec":
        """quint8-style activation spec: unsigned affine, 7-bit narrowed by default."""
        return cls.make(
            bits,
            signed=False,
            symmetric=symmetric,
            per_channel=per_channel,
            axis=axis,
            narrow_to_bits=bits - 1 if reduce_range else None,
        )

    def symmetric_init_shift(self, init_scale: float) -> float:
        """Symmetric-mode initial shift: ``-(|qmin+qmax| // 2) * sign(qmin+qmax) * init_scale``."""
        ssum = self.quant_min + self.quant_max
        sign = math.copysign(1.0, ssum)
        return -float(abs(ssum) // 2) * sign * init_scale
