"""LSQ/LSQ+ fake-quant forward and backward kernels (port of
``jaxlsq/ops/pallas_kernels.py``: ``pallas_forward`` / ``pallas_backward``).

* On a CPU tensor each function runs its plain version, the golden math of
  ``core/golden.py``.
* On a CUDA tensor it launches ``csrc/fake_quant.cu`` (``fq_fwd_pt``,
  ``fq_fwd_pc``, ``fq_bwd_pt``, ``fq_bwd_pc``) or raises; there is no path
  from a CUDA tensor to the plain version.  The kernels take f32 only.

A per-channel tensor is handed to the kernels as its ``(outer, C, inner)``
view around ``spec.axis``, so the channel axis is never moved.  The qparams
stay on the device.  ``LAUNCHES`` counts the kernel launches of each kind.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import _build
from ..core.golden import effective_grad_scale, golden_backward, golden_forward
from ..core.spec import QuantSpec

__all__ = ["fake_quant_forward", "fake_quant_backward", "LAUNCHES"]

LAUNCHES = {"fq_fwd_pt": 0, "fq_fwd_pc": 0, "fq_bwd_pt": 0, "fq_bwd_pc": 0}

_MAX_NUMEL = 2 ** 31 - 1  # the kernels index with 32-bit ints


def _view3(x: torch.Tensor, spec: QuantSpec) -> Tuple[int, int, int]:
    if not spec.per_channel:
        return 1, 1, x.numel()
    axis = spec.axis % x.dim()
    return (math.prod(x.shape[:axis]), x.shape[axis],
            math.prod(x.shape[axis + 1:]))


def _check_cuda(what: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    for t in (x,) + others:
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{what}: the CUDA kernels take float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: tensors on {t.device} and {x.device}")
    if x.numel() > _MAX_NUMEL:
        raise ValueError(f"{what}: {x.numel()} elements exceed the kernels' "
                         "32-bit indexing")


def _qparams(scale, shift, c: int, what: str):
    scale, shift = scale.contiguous(), shift.contiguous()
    if scale.numel() != c or shift.numel() != c:
        raise ValueError(f"{what}: qparams must have {c} elements, got "
                         f"{scale.numel()}/{shift.numel()}")
    return scale, shift


def _range(spec: QuantSpec):
    return (float(spec.quant_min), float(spec.quant_max),
            float(spec.type_min), float(spec.type_max))


def fake_quant_forward(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                       spec: QuantSpec, init_mode: bool = False) -> torch.Tensor:
    """Fake-quantized ``x``; ``init_mode`` returns ``x`` itself, no launch."""
    if init_mode:
        return x
    if x.device.type == "cpu":
        return golden_forward(x, scale, shift, spec)
    _check_cuda("fake_quant_forward", x, scale, shift)
    outer, c, inner = _view3(x, spec)
    scale, shift = _qparams(scale, shift, c, "fake_quant_forward")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if spec.per_channel:
        err = lib.jlt_fq_fwd_pc(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                                out.data_ptr(), outer, c, inner, *_range(spec),
                                stream)
        LAUNCHES["fq_fwd_pc"] += 1
    else:
        err = lib.jlt_fq_fwd_pt(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                                out.data_ptr(), x.numel(), *_range(spec), stream)
        LAUNCHES["fq_fwd_pt"] += 1
    _build.check(err, "fake_quant_forward")
    return out


def fake_quant_backward(grad: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, spec: QuantSpec,
                        eval_mode: bool = False, init_mode: bool = False,
                        numel: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dX, dS, dB)``: dX the STE gradient (``grad`` itself in init mode),
    dS/dB reduced to the qparams' shape (zeros in eval mode)."""
    if x.device.type == "cpu":
        return golden_backward(grad, x, scale, shift, spec, eval_mode=eval_mode,
                               init_mode=init_mode, numel=numel)
    _check_cuda("fake_quant_backward", x, grad, scale, shift)
    if grad.shape != x.shape:
        raise ValueError(f"fake_quant_backward: grad {tuple(grad.shape)} != x "
                         f"{tuple(x.shape)}")
    outer, c, inner = _view3(x, spec)
    scale, shift = _qparams(scale, shift, c, "fake_quant_backward")
    if eval_mode or x.numel() == 0:
        ds, db = torch.zeros_like(scale), torch.zeros_like(shift)
        if init_mode or x.numel() == 0:
            return (grad if init_mode else torch.zeros_like(x)), ds, db
    else:
        ds, db = torch.empty_like(scale), torch.empty_like(shift)
    x, grad = x.contiguous(), grad.contiguous()
    dx = grad if init_mode else torch.empty_like(x)
    lib = _build.load_library()
    n_part = 0 if eval_mode else 2 * lib.jlt_fq_partials(outer, c, inner,
                                                        int(spec.per_channel))
    part = torch.empty(max(n_part, 1), dtype=torch.float32, device=x.device)
    n = numel if numel is not None else x.numel()
    gs = effective_grad_scale(spec, n, c)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (grad.data_ptr(), x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            dx.data_ptr(), part.data_ptr(), ds.data_ptr(), db.data_ptr())
    flags = (int(spec.symmetric), int(eval_mode), int(init_mode), gs, stream)
    if spec.per_channel:
        err = lib.jlt_fq_bwd_pc(*args, outer, c, inner, *_range(spec), *flags)
        LAUNCHES["fq_bwd_pc"] += 1
    else:
        err = lib.jlt_fq_bwd_pt(*args, x.numel(), *_range(spec), *flags)
        LAUNCHES["fq_bwd_pt"] += 1
    _build.check(err, "fake_quant_backward")
    return dx, ds, db
