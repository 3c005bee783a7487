"""Golden fake-quant math: the numeric contract every other path meets.

Port of ``jaxlsq/core/golden.py``: ``clamp_scale``, ``broadcast_qparams``,
``effective_grad_scale``, the forward/backward pair ``golden_forward`` /
``golden_backward`` and their traced-flag twins ``golden_forward_traced`` /
``golden_backward_traced`` (the modes as f32 0/1 device scalars, so one
program covers every phase).  These are the plain versions of the fake-quant
CUDA kernels (``jaxlsq_torch/ops/fake_quant.py``), which run them for CPU
tensors.

``torch.round`` rounds half to even, like ``jnp.round``.  A per-channel
``spec.axis`` may be negative here; it counts from the last axis.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .spec import QuantSpec

__all__ = ["clamp_scale", "broadcast_qparams", "effective_grad_scale",
           "golden_forward", "golden_backward", "golden_forward_traced",
           "golden_backward_traced"]


def clamp_scale(scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``s = max(eps, |scale|)`` with eps the machine epsilon of ``dtype``."""
    eps = torch.finfo(dtype).eps
    return torch.clamp_min(scale.to(dtype).abs(), eps)


def effective_grad_scale(spec: QuantSpec, numel: int, num_channels: int = 1) -> float:
    """LSQ gradient scale ``grad_scaler / sqrt(numel * qmax [/ C])``; the
    per-channel ``/ C`` is the JAX package's deliberate deviation from the
    reference's CUDA path (PARITY.md)."""
    if not spec.use_grad_scaling:
        return float(spec.grad_scaler)
    n = float(numel) * float(spec.quant_max)
    if spec.per_channel:
        n = n / float(num_channels)
    return float(spec.grad_scaler) / math.sqrt(n)


def broadcast_qparams(q: torch.Tensor, x_ndim: int, axis: int) -> torch.Tensor:
    """Reshape a 1-D per-channel qparam to broadcast against x along ``axis``."""
    shape = [1] * x_ndim
    shape[axis] = q.shape[0] if q.dim() > 0 else 1
    return q.reshape(shape)


def _prep(x, scale, shift, spec: QuantSpec):
    s = clamp_scale(scale, x.dtype)
    b = shift.to(x.dtype)
    if spec.per_channel:
        s = broadcast_qparams(s, x.dim(), spec.axis % x.dim())
        b = broadcast_qparams(b, x.dim(), spec.axis % x.dim())
    zp = torch.round(torch.clamp(-b / s, spec.type_min, spec.type_max))
    return s, zp


def golden_forward(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   spec: QuantSpec, *, init_mode: bool = False) -> torch.Tensor:
    """Fake-quantize forward: ``(round(clamp(x/s + zp, qmin, qmax)) - zp) * s``
    with ``zp = round(clamp(-shift/s, tmin, tmax))``; ``init_mode`` is the
    identity."""
    if init_mode:
        return x
    s, zp = _prep(x, scale, shift, spec)
    xq = torch.round(torch.clamp(x / s + zp, spec.quant_min, spec.quant_max))
    return (xq - zp) * s


def golden_backward(grad: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor, spec: QuantSpec, *,
                    eval_mode: bool = False, init_mode: bool = False,
                    numel: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fake-quantize backward; returns ``(dX, dS, dB)`` with dS/dB reduced to
    the shape of scale/shift.

    The mask is strict on the unrounded ``xq``; eval mode gives the STE dX and
    zero dS/dB; init mode (LSQ+ backprop init) passes dX through and trains
    scale/shift on ``||x_fq - x||^2``.  ``numel`` overrides ``x.numel()`` in
    the gradient scale, which is applied after the sums.
    """
    s, zp = _prep(x, scale, shift, spec)
    qmin, qmax = float(spec.quant_min), float(spec.quant_max)

    xq = torch.clamp(x / s + zp, qmin, qmax)  # unrounded for the mask
    mask = (qmin < xq) & (xq < qmax)
    dX = grad if init_mode else grad * mask
    if eval_mode:
        return (dX, torch.zeros_like(scale, dtype=x.dtype),
                torch.zeros_like(shift, dtype=x.dtype))

    xfq = (torch.round(xq) - zp) * s
    geff = 2.0 * (xfq - x) if init_mode else grad
    db_elem = torch.where(mask, 0.0, geff)
    if spec.symmetric:
        db_elem = torch.zeros_like(db_elem)
    border = torch.where(xq <= qmin, geff * (qmin - zp), geff * (qmax - zp))
    ds_elem = torch.where(mask, geff * (xfq - x) / s, border)

    n = numel if numel is not None else x.numel()
    if spec.per_channel:
        axis = spec.axis % x.dim()
        gs = effective_grad_scale(spec, n, x.shape[axis])
        red = tuple(a for a in range(x.dim()) if a != axis)
        dS = ds_elem.sum(dim=red) * gs if red else ds_elem * gs
        dB = db_elem.sum(dim=red) * gs if red else db_elem * gs
    else:
        gs = effective_grad_scale(spec, n)
        dS = ds_elem.sum().reshape(scale.shape) * gs
        dB = db_elem.sum().reshape(shift.shape) * gs
    return dX, dS.to(scale.dtype), dB.to(shift.dtype)


# The traced-flag twins take eval/init as f32 0/1 scalars (tensors), so the
# phase is a device value and never a host branch.  For flags in {0, 1} they
# equal the static functions above.

def golden_forward_traced(x: torch.Tensor, scale: torch.Tensor,
                          shift: torch.Tensor, spec: QuantSpec, eval_flag,
                          init_flag) -> torch.Tensor:
    """``init ? x : fake_quant(x)``; ``eval_flag`` changes only the backward.

    The JAX package's golden blends ``init·x + (1 − init)·fq``; this selects,
    as its Pallas kernel and the CUDA kernel do.  The two agree for finite x
    (a blended -0.0 input comes out +0.0)."""
    del eval_flag
    s, zp = _prep(x, scale, shift, spec)
    xq = torch.round(torch.clamp(x / s + zp, spec.quant_min, spec.quant_max))
    fq = (xq - zp) * s
    ini = torch.as_tensor(init_flag, dtype=torch.float32, device=x.device).reshape(())
    return torch.where(ini > 0, x, fq)


def golden_backward_traced(grad: torch.Tensor, x: torch.Tensor,
                           scale: torch.Tensor, shift: torch.Tensor,
                           spec: QuantSpec, eval_flag, init_flag,
                           numel: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dX, dS, dB)`` with the modes as flags: ``dX = init ? g : g·mask``;
    dS/dB are always summed and scaled by ``gs·(1 − eval)``."""
    s, zp = _prep(x, scale, shift, spec)
    qmin, qmax = float(spec.quant_min), float(spec.quant_max)
    ev = torch.as_tensor(eval_flag, dtype=torch.float32, device=x.device).reshape(())
    ini = torch.as_tensor(init_flag, dtype=torch.float32, device=x.device).reshape(())

    xq = torch.clamp(x / s + zp, qmin, qmax)
    mask = (qmin < xq) & (xq < qmax)
    dX = torch.where(ini > 0, grad, grad * mask)

    xfq = (torch.round(xq) - zp) * s
    geff = torch.where(ini > 0, 2.0 * (xfq - x), grad)
    db_elem = torch.where(mask, 0.0, geff)
    if spec.symmetric:
        db_elem = torch.zeros_like(db_elem)
    border = torch.where(xq <= qmin, geff * (qmin - zp), geff * (qmax - zp))
    ds_elem = torch.where(mask, geff * (xfq - x) / s, border)

    n = numel if numel is not None else x.numel()
    live = 1.0 - ev  # eval zeroes the qparam gradients
    if spec.per_channel:
        axis = spec.axis % x.dim()
        gs = effective_grad_scale(spec, n, x.shape[axis])
        red = tuple(a for a in range(x.dim()) if a != axis)
        dS = (ds_elem.sum(dim=red) if red else ds_elem) * (gs * live)
        dB = (db_elem.sum(dim=red) if red else db_elem) * (gs * live)
    else:
        gs = effective_grad_scale(spec, n)
        dS = ds_elem.sum().reshape(scale.shape) * (gs * live)
        dB = db_elem.sum().reshape(shift.shape) * (gs * live)
    return dX, dS.to(scale.dtype), dB.to(shift.dtype)
