"""Public functional fake-quant with its custom backward (port of
``jaxlsq/ops/functional.py``: ``fake_quant``, ``lsq`` and
``fake_quant_traced``).

Each is one ``torch.autograd.Function`` that saves the raw ``(x, scale,
shift)``, as the JAX package's ``custom_vjp`` does, and calls
``ops.fake_quant``: the CUDA kernels for CUDA tensors, the golden math for
CPU tensors.  ``fake_quant`` takes the modes as host bools;
``fake_quant_traced`` takes them as device flags, so one program (a captured
CUDA graph) covers every phase.  The backward is ``once_differentiable``:
unlike the JAX package's golden path, the port has no double backward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..core.spec import QuantSpec
from .fake_quant import (fake_quant_backward, fake_quant_backward_traced,
                         fake_quant_forward, fake_quant_forward_traced)

__all__ = ["fake_quant", "fake_quant_traced", "lsq"]


class _FakeQuant(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, shift, spec, eval_mode, init_mode, numel):
        ctx.save_for_backward(x, scale, shift)
        ctx.cfg = (spec, eval_mode, init_mode, numel)
        out = fake_quant_forward(x, scale, shift, spec, init_mode)
        # init mode returns x itself: hand autograd a view of it
        return out.view_as(out) if out is x else out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, scale, shift = ctx.saved_tensors
        spec, eval_mode, init_mode, numel = ctx.cfg
        dx, ds, db = fake_quant_backward(grad, x, scale, shift, spec,
                                         eval_mode, init_mode, numel)
        return dx, ds, db, None, None, None, None


class _FakeQuantTraced(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, shift, flags, spec, numel):
        ctx.save_for_backward(x, scale, shift, flags)
        ctx.cfg = (spec, numel)
        return fake_quant_forward_traced(x, scale, shift, flags, spec)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, scale, shift, flags = ctx.saved_tensors
        spec, numel = ctx.cfg
        dx, ds, db = fake_quant_backward_traced(grad, x, scale, shift, flags,
                                                spec, numel)
        return dx, ds, db, None, None, None


def _checked_qparams(x, scale, shift, spec: QuantSpec):
    """1-D qparams, a (1,) one broadcast to C per channel (its gradient is
    summed back)."""
    if scale.dim() != 1 or shift.dim() != 1:
        raise ValueError(
            "scale/shift must be 1-D, even per-tensor; got "
            f"scale.ndim={scale.dim()}, shift.ndim={shift.dim()}")
    if spec.per_channel:
        c = x.shape[spec.axis]
        if scale.shape[0] == 1 and c > 1:
            scale = scale.expand(c)
        if shift.shape[0] == 1 and c > 1:
            shift = shift.expand(c)
        if scale.shape[0] != c or shift.shape[0] != c:
            raise ValueError(
                f"per-channel qparams must have size {c} (axis {spec.axis}); "
                f"got {scale.shape[0]}/{shift.shape[0]}")
    return scale, shift


def fake_quant(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               spec: QuantSpec, *, eval_mode: bool = False,
               init_mode: bool = False, numel: Optional[int] = None) -> torch.Tensor:
    """LSQ/LSQ+ fake quantization with learned scale/shift.

    ``scale``/``shift`` are 1-D: (1,) per tensor or (C,) per channel along
    ``spec.axis``; a (1,) qparam is broadcast to C per channel, and its
    gradient is summed back.  ``eval_mode``: forward unchanged, STE dX,
    zero dS/dB.  ``init_mode``: identity forward, dS/dB from
    ``||x_fq - x||^2`` (LSQ+ backprop init).  ``numel`` overrides
    ``x.numel()`` in the gradient scale.
    """
    scale, shift = _checked_qparams(x, scale, shift, spec)
    return _FakeQuant.apply(x, scale, shift, spec, bool(eval_mode),
                            bool(init_mode), numel)


def fake_quant_traced(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                      spec: QuantSpec, *, eval_flag, init_flag,
                      numel: Optional[int] = None) -> torch.Tensor:
    """``fake_quant`` with the modes as f32 0/1 flags: () or (1,) tensors
    (or numbers) that stay on the device, so no host branch decides the
    phase and one captured program covers the observer window, backprop
    init and full LSQ.  The flags get no gradient."""
    scale, shift = _checked_qparams(x, scale, shift, spec)
    flags = torch.stack([
        torch.as_tensor(f, dtype=torch.float32, device=x.device).detach().reshape(())
        for f in (eval_flag, init_flag)])
    return _FakeQuantTraced.apply(x, scale, shift, flags, spec, numel)


def lsq(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
        quant_min: int = 0, quant_max: int = 255,
        type_min: Optional[int] = None, type_max: Optional[int] = None,
        axis: int = 1, use_grad_scaling: bool = True, grad_scaler: float = 1.0,
        is_affine: bool = True, is_perchannel: bool = False,
        eval_mode: bool = False, init_mode: bool = False, *,
        numel: Optional[int] = None) -> torch.Tensor:
    """The reference's ``torchlsq.functional.lsq`` signature and defaults
    (quint8 range 0..255, axis 1, affine, per tensor)."""
    spec = QuantSpec(quant_min=quant_min, quant_max=quant_max,
                     type_min=type_min, type_max=type_max,
                     symmetric=not is_affine, per_channel=is_perchannel,
                     axis=axis, use_grad_scaling=use_grad_scaling,
                     grad_scaler=grad_scaler)
    return fake_quant(x, scale, shift, spec, eval_mode=eval_mode,
                      init_mode=init_mode, numel=numel)
