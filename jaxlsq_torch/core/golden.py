"""Golden fake-quant math, the part the serving path needs.

Port of ``jaxlsq/core/golden.py``: ``clamp_scale``, ``broadcast_qparams`` and
the forward ``golden_forward``.  The backward and the traced-flag twins belong
to the training path and are not here yet.

``torch.round`` rounds half to even, like ``jnp.round``.
"""

from __future__ import annotations

import torch

from .spec import QuantSpec

__all__ = ["clamp_scale", "broadcast_qparams", "golden_forward"]


def clamp_scale(scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``s = max(eps, |scale|)`` with eps the machine epsilon of ``dtype``."""
    eps = torch.finfo(dtype).eps
    return torch.clamp_min(scale.to(dtype).abs(), eps)


def broadcast_qparams(q: torch.Tensor, x_ndim: int, axis: int) -> torch.Tensor:
    """Reshape a 1-D per-channel qparam to broadcast against x along ``axis``."""
    shape = [1] * x_ndim
    shape[axis] = q.shape[0] if q.dim() > 0 else 1
    return q.reshape(shape)


def golden_forward(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   spec: QuantSpec) -> torch.Tensor:
    """Fake-quantize forward: ``(round(clamp(x/s + zp, qmin, qmax)) - zp) * s``
    with ``zp = round(clamp(-shift/s, tmin, tmax))``."""
    s = clamp_scale(scale, x.dtype)
    b = shift.to(x.dtype)
    if spec.per_channel:
        s = broadcast_qparams(s, x.dim(), spec.axis)
        b = broadcast_qparams(b, x.dim(), spec.axis)
    zp = torch.round(torch.clamp(-b / s, spec.type_min, spec.type_max))
    xq = torch.round(torch.clamp(x / s + zp, spec.quant_min, spec.quant_max))
    return (xq - zp) * s
