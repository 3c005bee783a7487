"""Batch normalization with flax ``nn.BatchNorm``'s rule, over axis 1 (NCHW
or (B, C)).

flax and ``nn.BatchNorm2d`` differ in three ways that each change the
numbers, so the port does not use the latter: flax's running average keeps
``0.99`` of the old value (torch's momentum 0.1 keeps 0.9), its variance is
the biased "fast" ``E[x²] − E[x]²`` (clipped at 0), and that biased batch
variance is what it stores (torch stores the unbiased one).  Under a split
of the rows over processes (a multi-device step) E[x] and E[x²] are the
global batch's, all-reduced with a backward.  The names
``scale``/``bias``/``mean``/``var`` are flax's.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import _dist
from .._device import resolve_device

__all__ = ["BatchNorm"]


class BatchNorm(nn.Module):
    """``y = (x − µ) · (rsqrt(σ² + eps) · scale) + bias`` with batch
    statistics in training (and a running-average update) and the running
    ones in eval mode."""

    def __init__(self, num_features: int, *, momentum: float = 0.99,
                 epsilon: float = 1e-5, device=None):
        super().__init__()
        device = resolve_device(device)
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("mean", torch.zeros(num_features, device=device))
        self.register_buffer("var", torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = (0,) + tuple(range(2, x.dim()))
            mean = x.mean(dim=dims)
            ex2 = (x * x).mean(dim=dims)
            split = _dist.current()
            if split is not None:  # the global batch's moments
                mean, ex2 = _dist.mean_grad(mean, split), _dist.mean_grad(ex2, split)
            var = torch.clamp_min(ex2 - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
