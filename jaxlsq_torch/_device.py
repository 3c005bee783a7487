"""Device choice for the port's entry points: CUDA unless the caller asks
for another device; with no card and no device given, construction raises
rather than carrying on on the CPU."""

from __future__ import annotations

import itertools

import torch


def resolve_device(device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to run "
            "the plain PyTorch path on the CPU")
    return torch.device("cuda")


def device_of(module) -> torch.device:
    """The device of ``module``'s first parameter or buffer (the CPU for a
    module that holds neither)."""
    for t in itertools.chain(module.parameters(), module.buffers()):
        return t.device
    return torch.device("cpu")
