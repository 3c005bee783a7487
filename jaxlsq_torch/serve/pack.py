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

:func:`quantize_weight_grouped` is the group-wise serving form: one symmetric
abs-max scale per (K-group, output channel), a (G, N) ``scale`` and
``group_size`` set, re-quantized from the float weight at convert time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.golden import broadcast_qparams, clamp_scale
from ..core.spec import QuantSpec

__all__ = ["PackedWeight", "quantize_weight", "quantize_weight_grouped",
           "dequantize_weight", "pack_int4", "unpack_int4"]


@dataclasses.dataclass
class PackedWeight:
    """Quantized serving weight: int8 carrier data + qparams.

    ``scale`` is (C,) f32 per-channel or (1,) per-tensor; ``zero_point`` the
    matching int32.  ``axis`` is the per-channel axis of the ORIGINAL tensor,
    ``k_axis`` the contraction axis along which int4 packs.  With
    ``group_size`` set (:func:`quantize_weight_grouped`) ``scale`` is (G, N),
    one row per group of ``group_size`` rows of K, and ``zero_point`` is (1,)
    zeros (symmetric).
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


def true_div(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` as an IEEE division on every device: CUDA PyTorch turns a
    division by a host scalar into a multiplication by its reciprocal, which
    can differ in the last bit, so a scale computed on the card would
    quantize differently from the same scale computed on the CPU."""
    return a / torch.full_like(a, c)


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


def quantize_weight_grouped(w: torch.Tensor, *, group_size: int,
                            bits: int = 4) -> PackedWeight:
    """Group-wise symmetric quantization of a dense (K, N) weight:
    ``s[g, n] = max |w[k, n]| over group g / (2^(bits-1) - 1)`` (floored at
    f32 eps), ``q = round(clamp(w / s, -qmax, qmax))``.  The learned
    per-channel LSQ scale is superseded; ``group_size == K`` is per-channel."""
    if w.dim() != 2:
        raise ValueError("grouped quantization needs a 2-D (K, N) weight; "
                         f"got shape {tuple(w.shape)}")
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    k, n = w.shape
    if group_size < 1 or k % group_size:
        raise ValueError(
            f"group_size {group_size} must divide the contraction dim {k}")
    qmax = float(2 ** (bits - 1) - 1)
    wf = w.to(torch.float32)
    s = true_div(wf.reshape(k // group_size, group_size, n).abs().amax(dim=1), qmax)
    s = torch.clamp_min(s, torch.finfo(torch.float32).eps)
    q = torch.round(torch.clamp(wf / s.repeat_interleave(group_size, dim=0),
                                -qmax, qmax)).to(torch.int8)
    return PackedWeight(data=pack_int4(q, 0) if bits == 4 else q, scale=s,
                        zero_point=torch.zeros(1, dtype=torch.int32, device=w.device),
                        bits=bits, axis=1, k_axis=0, orig_shape=(k, n),
                        group_size=int(group_size))


def dequantize_weight(p: PackedWeight, dtype=torch.float32) -> torch.Tensor:
    """Plain dequant ``(w_q - zp) * s``: the oracle for the fused kernels."""
    q = unpack_int4(p.data, p.k_axis) if p.bits == 4 else p.data
    if p.orig_shape and q.shape[p.k_axis] != p.orig_shape[p.k_axis]:
        q = q.narrow(p.k_axis, 0, p.orig_shape[p.k_axis])  # odd-K pad
    if p.group_size is not None:  # (G, N) -> (K, N), symmetric (zp == 0)
        s = p.scale.repeat_interleave(p.group_size, dim=0)
        return (q.to(torch.float32) * s).to(dtype)
    ndim = len(p.orig_shape)
    per_channel = p.scale.shape[0] > 1 or p.scale.shape[0] == p.orig_shape[p.axis]
    if per_channel and p.scale.shape[0] == p.orig_shape[p.axis]:
        s = broadcast_qparams(p.scale, ndim, p.axis)
        z = broadcast_qparams(p.zero_point.to(torch.float32), ndim, p.axis)
    else:
        s, z = p.scale, p.zero_point.to(torch.float32)
    return ((q.to(torch.float32) - z) * s).to(dtype)
