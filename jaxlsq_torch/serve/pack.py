"""Weight quantization + packing for the int8/int4 serving path.

Port of ``jaxlsq/serve/pack.py``.  Formats:

* ``int8``: one int8 per element.
* ``int4``: two 4-bit values per int8 byte along the contraction (K) axis in
  the SPLIT-HALF layout: byte row r holds k=r in its low nibble and k=r+K/2 in
  its high nibble.  Odd K is zero-padded by one row; ``orig_shape`` keeps the
  logical size.

Quantization matches the fake-quant forward exactly:
``w_q = round(clamp(w/s + zp, qmin, qmax))`` with
``zp = round(clamp(-shift/s, tmin, tmax))`` and eps-clamped ``s``, so
``dequantize_weight(quantize_weight(w)) == golden_forward(w)`` bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.golden import broadcast_qparams, clamp_scale
from ..core.spec import QuantSpec

__all__ = ["PackedWeight", "quantize_weight", "dequantize_weight", "pack_int4",
           "unpack_int4"]


@dataclasses.dataclass
class PackedWeight:
    """Quantized serving weight: int8 carrier data + qparams.

    ``scale`` is (C,) f32 per-channel or (1,) per-tensor; ``zero_point`` the
    matching int32.  ``axis`` is the per-channel axis of the ORIGINAL tensor,
    ``k_axis`` the contraction axis along which int4 packs.  ``group_size`` is
    carried for layout compatibility with the JAX package; group-wise packing
    comes with a later slice.
    """

    data: torch.Tensor
    scale: torch.Tensor
    zero_point: torch.Tensor
    bits: int = 8
    axis: int = 1
    k_axis: int = 0
    orig_shape: Tuple[int, ...] = ()
    group_size: Optional[int] = None

    def to(self, device) -> "PackedWeight":
        return dataclasses.replace(self, data=self.data.to(device),
                                   scale=self.scale.to(device),
                                   zero_point=self.zero_point.to(device))


def pack_int4(q: torch.Tensor, k_axis: int) -> torch.Tensor:
    """Pack int8-held values in [-8, 7] two per byte along ``k_axis``
    (split-half); odd K is zero-padded by one row."""
    k = q.shape[k_axis]
    if k % 2:
        pad_shape = list(q.shape)
        pad_shape[k_axis] = 1
        q = torch.cat([q, torch.zeros(pad_shape, dtype=q.dtype, device=q.device)],
                      dim=k_axis)
        k += 1
    lo = q.narrow(k_axis, 0, k // 2)
    hi = q.narrow(k_axis, k // 2, k // 2)
    return ((lo & 0x0F) | (hi << 4)).to(torch.int8)


def unpack_int4(p: torch.Tensor, k_axis: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`, sign-extending both nibbles."""
    lo = (p << 4) >> 4  # int8 arithmetic shifts sign-extend
    hi = p >> 4
    return torch.cat([lo, hi], dim=k_axis).to(torch.int8)


def _fold_qparams(scale: torch.Tensor, shift: torch.Tensor, spec: QuantSpec):
    """(scale, shift) -> (eps-clamped scale, int32 zero_point)."""
    s = clamp_scale(scale, torch.float32)
    zp = torch.round(torch.clamp(-shift.to(torch.float32) / s,
                                 spec.type_min, spec.type_max)).to(torch.int32)
    return s, zp


def quantize_weight(w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                    spec: QuantSpec, *, bits: Optional[int] = None,
                    k_axis: Optional[int] = None) -> PackedWeight:
    """Quantize + pack a trained weight with its learned LSQ qparams.

    ``bits`` defaults to 4 when the quant range fits the signed int4 carrier
    [-8, 7], else 8.  ``k_axis`` defaults to 0 for a dense (K, N) kernel.
    """
    if bits is None:
        bits = 4 if (-8 <= spec.quant_min and spec.quant_max <= 7) else 8
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if bits == 4 and not (-8 <= spec.quant_min and spec.quant_max <= 7):
        raise ValueError(
            f"quant range [{spec.quant_min},{spec.quant_max}] does not fit the "
            "int4 carrier; train with QuantSpec.make(4, signed=True)")
    if k_axis is None:
        k_axis = 0 if w.dim() == 2 else w.dim() - 2

    s, zp = _fold_qparams(scale, shift, spec)
    if spec.per_channel:
        sb = broadcast_qparams(s, w.dim(), spec.axis)
        zb = broadcast_qparams(zp, w.dim(), spec.axis).to(torch.float32)
    else:
        sb, zb = s, zp.to(torch.float32)
    q = torch.round(torch.clamp(w.to(torch.float32) / sb + zb,
                                spec.quant_min, spec.quant_max)).to(torch.int8)
    data = pack_int4(q, k_axis) if bits == 4 else q
    return PackedWeight(data=data, scale=s, zero_point=zp, bits=bits,
                        axis=spec.axis, k_axis=k_axis, orig_shape=tuple(w.shape))


def dequantize_weight(p: PackedWeight, dtype=torch.float32) -> torch.Tensor:
    """Plain dequant ``(w_q - zp) * s``: the oracle for the fused kernels."""
    if p.group_size is not None:
        raise NotImplementedError(
            "group-wise int4 weights arrive with the grouped-int4 slice")
    q = unpack_int4(p.data, p.k_axis) if p.bits == 4 else p.data
    if p.orig_shape and q.shape[p.k_axis] != p.orig_shape[p.k_axis]:
        q = q.narrow(p.k_axis, 0, p.orig_shape[p.k_axis])  # odd-K pad
    ndim = len(p.orig_shape)
    per_channel = p.scale.shape[0] > 1 or p.scale.shape[0] == p.orig_shape[p.axis]
    if per_channel and p.scale.shape[0] == p.orig_shape[p.axis]:
        s = broadcast_qparams(p.scale, ndim, p.axis)
        z = broadcast_qparams(p.zero_point.to(torch.float32), ndim, p.axis)
    else:
        s, z = p.scale, p.zero_point.to(torch.float32)
    return ((q.to(torch.float32) - z) * s).to(dtype)
