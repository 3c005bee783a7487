"""Weight-only int8/int4 matmul with the dequant fused in (port of
``jaxlsq/serve/matmul.py::wo_matmul``).

``wo_matmul(x, packed)`` computes ``x @ dequant(packed)`` for a logical
(K, N) weight with per-channel qparams on N (or (1,) per-tensor), or with
group-wise (G, N) scales (``packed.group_size``, int4).

* On a CPU tensor it runs the plain version :func:`wo_matmul_plain`
  (``x @ dequantize_weight(packed)`` in f32).
* On a CUDA tensor it launches ``csrc/wo_matmul.cu`` (``wo8`` for int8,
  ``wo4`` for split-half int4, ``wo4g`` for group-wise int4) for every M, or
  raises.  Each is one launch with no workspace (the wrapper allocates only
  ``out``), on one kernel body templated on the weight format, and sums in
  one order for every M: 32-row slices of the weight's rows (int4: byte
  rows, each giving its low nibble's term and then its high nibble's, k = r
  and k = r + ceil(K/2)), each an fmaf chain from +0 of exact f32 factors
  (``(w - z)``, the zero point applied to each byte or nibble; ``wo4g``
  ``w * s[k // gs]``), folded in slice order, times ``s`` (not ``wo4g``).
  ``wo4g`` takes group sizes and K / 2 that are multiples of 128 (the JAX
  package's TPU limits do not apply); another grouped pack raises
  ``ValueError``.

``LAUNCHES`` counts the kernel launches of each kind.  The int8×int8 paths
(``static_int8_matmul``, ``dynamic_int8_matmul``) come with a later slice.
"""

from __future__ import annotations

import torch

from .. import _build
from .pack import PackedWeight, dequantize_weight

__all__ = ["wo_matmul", "wo_matmul_plain", "LAUNCHES"]

LAUNCHES = {"wo8": 0, "wo4": 0, "wo4g": 0}


def wo_matmul_plain(x: torch.Tensor, packed: PackedWeight) -> torch.Tensor:
    """``x @ dequant(W)`` in f32: the reference for the kernels."""
    w = dequantize_weight(packed, torch.float32)
    return torch.matmul(x.to(torch.float32), w)


def _launch(x2d: torch.Tensor, packed: PackedWeight) -> torch.Tensor:
    kdim, n = packed.orig_shape
    m = x2d.shape[0]
    dev = x2d.device
    for name, t in (("data", packed.data), ("scale", packed.scale),
                    ("zero_point", packed.zero_point)):
        if t.device != dev:
            raise ValueError(f"wo_matmul: packed.{name} is on {t.device}, x on {dev}")
    data = packed.data.contiguous()
    if data.dtype != torch.int8 or data.data_ptr() % 4:
        raise ValueError("wo_matmul: packed data must be 4-byte aligned int8")
    rows = kdim if packed.bits == 8 else (kdim + 1) // 2
    if tuple(data.shape) != (rows, n):
        raise ValueError(f"wo_matmul: packed data shape {tuple(data.shape)} "
                         f"!= {(rows, n)} for bits={packed.bits}, K={kdim}")
    scale = packed.scale.to(torch.float32).contiguous()
    zp = packed.zero_point.to(torch.int32).contiguous()
    gs = packed.group_size or 0
    lib = _build.load_library()
    if gs:
        align = lib.group_rows
        if packed.bits != 4 or kdim % 2 or gs % align or (kdim // 2) % align:
            raise ValueError(
                f"wo_matmul: the wo4g kernel takes int4 packs whose group size "
                f"and K / 2 are multiples of {align} (got bits={packed.bits}, "
                f"group_size={gs}, K={kdim})")
        if tuple(scale.shape) != (kdim // gs, n):
            raise ValueError(f"wo_matmul: group scales {tuple(scale.shape)} "
                             f"!= {(kdim // gs, n)}")
    elif scale.numel() not in (1, n) or zp.numel() != scale.numel():
        raise ValueError("wo_matmul: qparams must be (N,) or (1,)")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    per_channel = int(scale.numel() == n and n > 1)
    args = (x2d.data_ptr(), data.data_ptr(), scale.data_ptr(), zp.data_ptr(),
            out.data_ptr(), m, kdim, n, per_channel)
    if packed.bits == 8:
        err = lib.jlt_wo8(*args, stream)
        name = "wo8"
    else:
        err = lib.jlt_wo4(*args, gs, stream)
        name = "wo4g" if gs else "wo4"
    LAUNCHES[name] += 1
    _build.check(err, "wo_matmul")
    return out


def wo_matmul(x: torch.Tensor, packed: PackedWeight) -> torch.Tensor:
    """``x @ dequant(packed)`` for x (..., K); returns (..., N) f32."""
    if len(packed.orig_shape) != 2:
        raise ValueError("wo_matmul needs a 2-D (K, N) packed weight")
    kdim, n = packed.orig_shape
    if x.shape[-1] != kdim:
        raise ValueError(f"wo_matmul: x has K={x.shape[-1]}, weight K={kdim}")
    lead = x.shape[:-1]
    if x.device.type == "cpu":
        return wo_matmul_plain(x, packed)
    if x.device.type != "cuda":
        raise ValueError(f"wo_matmul: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"wo_matmul: the kernel takes f32 activations, got {x.dtype}")
    x2d = x.reshape(-1, kdim).contiguous()
    if x2d.shape[0] == 0:
        return x.new_zeros(*lead, n)
    return _launch(x2d, packed).reshape(*lead, n)
