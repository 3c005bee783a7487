"""Serve-mode quantized layers (port of the serve branches of
``jaxlsq/models/layers.py``).

:class:`QuantDense` holds a packed (K, N) kernel as buffers and runs the fused
weight-only matmul (``serve.matmul.wo_matmul``); :class:`QuantEmbed` holds an
int8 table and dequantizes only the gathered rows.  Both are filled by
:func:`jaxlsq_torch.interop.load_variables`.  The QAT (fake-quant training)
branches come with the training slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..serve.convert import serving_bits
from ..serve.matmul import wo_matmul
from ..serve.pack import PackedWeight
from .qconfig import QConfig

__all__ = ["QuantDense", "QuantEmbed", "static_act_quant"]


def static_act_quant(x: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
                     aspec) -> torch.Tensor:
    """Frozen fake-quant of an activation with converted qparams."""
    if scale.shape[0] > 1:
        s = scale.reshape((1,) * (x.dim() - 1) + (-1,))
    else:
        s = scale.reshape(())
    z = zp.to(x.dtype).reshape(s.shape)
    xq = torch.round(torch.clamp(x / s + z, aspec.quant_min, aspec.quant_max))
    return ((xq - z) * s).to(x.dtype)


def _check_serve(qc: QConfig, what: str) -> None:
    if qc.mode != "serve":
        raise NotImplementedError(
            f"{what}: only serve mode is ported so far; QAT layers arrive with "
            "the training slice (use qconfig.for_serving())")


class _PackedBuffers(nn.Module):
    """A PackedWeight held as buffers (data, scale, zero_point) plus its
    static layout fields."""

    def __init__(self, shape: Sequence[int], bits: int, axis: int, k_axis: int,
                 channels: int, device):
        super().__init__()
        dshape = list(shape)
        if bits == 4:
            dshape[k_axis] = (dshape[k_axis] + 1) // 2  # odd K pads one row
        self.register_buffer("data", torch.zeros(dshape, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(channels, dtype=torch.float32, device=device))
        self.register_buffer("zero_point", torch.zeros(channels, dtype=torch.int32,
                                                       device=device))
        self.bits, self.axis, self.k_axis = bits, axis, k_axis
        self.orig_shape = tuple(shape)

    def packed(self) -> PackedWeight:
        return PackedWeight(self.data, self.scale, self.zero_point, bits=self.bits,
                            axis=self.axis, k_axis=self.k_axis,
                            orig_shape=self.orig_shape)

    @torch.no_grad()
    def load(self, p: PackedWeight) -> None:
        # a per-tensor pack's axis is meaningless (its spec's placeholder)
        axis = p.axis if self.scale.numel() > 1 else self.axis
        if (p.bits, axis, p.k_axis, tuple(p.orig_shape)) != (
                self.bits, self.axis, self.k_axis, self.orig_shape):
            raise ValueError(
                f"packed weight layout (bits={p.bits}, axis={p.axis}, "
                f"k_axis={p.k_axis}, shape={tuple(p.orig_shape)}) does not match "
                f"the layer's (bits={self.bits}, axis={self.axis}, "
                f"k_axis={self.k_axis}, shape={self.orig_shape})")
        if p.group_size is not None:
            raise NotImplementedError(
                "group-wise int4 weights arrive with the grouped-int4 slice")
        for name in ("data", "scale", "zero_point"):
            buf = getattr(self, name)
            src = torch.as_tensor(getattr(p, name))
            if tuple(src.shape) != tuple(buf.shape):
                raise ValueError(f"packed {name} shape {tuple(src.shape)} != "
                                 f"{tuple(buf.shape)}")
            buf.copy_(src.to(buf.dtype))


class QuantDense(nn.Module):
    """Serve-mode dense layer: ``y = wo_matmul(x', W) + b`` where x' is x
    (``act_mode='none'``) or its frozen fake-quant (``'static'``).  Kernel
    layout (K, N), per-channel axis 1, as the JAX package."""

    def __init__(self, in_features: int, features: int, qconfig: QConfig, *,
                 use_bias: bool = True, path: Sequence[str] = (), device=None):
        super().__init__()
        qc = qconfig.resolve(tuple(path))
        _check_serve(qc, "QuantDense")
        if qc.act_mode not in ("none", "static"):
            raise NotImplementedError(
                f"act_mode {qc.act_mode!r} (int8 x int8 matmuls) arrives with "
                "the static/dynamic int8 slice")
        wspec = qc.required_weight_for_axis(1).spec
        c = features if wspec.per_channel else 1
        self.kernel = _PackedBuffers((in_features, features), serving_bits(wspec),
                                     1, 0, c, device)
        self.act_mode = qc.act_mode
        self.aspec = qc.activation.spec if qc.activation is not None else None
        if self.aspec is not None:
            ac = in_features if self.aspec.per_channel else 1
            self.register_buffer("act_scale", torch.ones(ac, dtype=torch.float32,
                                                         device=device))
            self.register_buffer("act_zp", torch.zeros(ac, dtype=torch.int32,
                                                       device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device),
                                  requires_grad=False) if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.aspec is not None and self.act_mode == "static":
            x = static_act_quant(x, self.act_scale, self.act_zp, self.aspec)
        y = wo_matmul(x, self.kernel.packed())
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


class QuantEmbed(nn.Module):
    """Serve-mode embedding: int8 table (always 8 bit: a row gather needs
    whole bytes) with per-row (or per-tensor) qparams; only the gathered rows
    are dequantized."""

    def __init__(self, num_embeddings: int, features: int, qconfig: QConfig, *,
                 path: Sequence[str] = (), device=None):
        super().__init__()
        qc = qconfig.resolve(tuple(path))
        _check_serve(qc, "QuantEmbed")
        wspec = qc.required_weight_for_axis(0).spec
        c = num_embeddings if wspec.per_channel else 1
        self.embedding = _PackedBuffers((num_embeddings, features), 8, 0, 0, c, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        p = self.embedding
        rows = p.data[tokens].to(torch.float32)
        if p.scale.shape[0] > 1:
            s = p.scale[tokens][..., None]
            z = p.zero_point[tokens][..., None]
        else:
            s, z = p.scale, p.zero_point
        return (rows - z.to(torch.float32)) * s
