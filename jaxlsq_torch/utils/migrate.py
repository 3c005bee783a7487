"""Migration from the reference framework: load torchlsq state dicts (port of
``jaxlsq/utils/migrate.py``).

The reference persists each ``LSQFakeQuantizer`` as state_dict entries:
learnable ``scale``/``shift`` parameters and the uint8 flag buffers
``fake_quant_enabled`` / ``observer_enabled`` / ``learning_enabled`` /
``current_batch``.  :func:`load_torchlsq_state` writes them into the port's
:class:`FakeQuantize` modules, in place (the JAX package returns a new
variables tree).  Plain ``torch.quantization.FakeQuantize`` entries (scale
and an integer ``zero_point``) are accepted too: ``shift = -zp * scale``.

Usage::

    load_torchlsq_state(model, torch_model.state_dict(), {
        "dense_0/act_fq":    "features.0.activation_post_process",
        "dense_0/weight_fq": "features.0.weight_fake_quant",
    })
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..models.layers import FakeQuantize

__all__ = ["load_torchlsq_state"]

_FLAG_KEYS = ("fake_quant_enabled", "observer_enabled", "learning_enabled")


def _np(value) -> np.ndarray:
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


@torch.no_grad()
def load_torchlsq_state(model: nn.Module, state_dict: Mapping,
                        mapping: Mapping[str, str]) -> nn.Module:
    """Copy reference quantizer state into ``model``'s quantizers in place.

    ``state_dict``: flat {torch key: tensor or numpy array}.  ``mapping``:
    {the JAX package's quantizer path ('a/b/act_fq'): torch module prefix}.
    A scale of size 1 broadcasts to the quantizer's channels.  Raises
    ``KeyError`` for a missing ``<prefix>.scale`` (shift/zero_point and the
    flags are optional) and ``ValueError`` for a scale of another shape.
    Returns ``model``."""
    for path_str, prefix in mapping.items():
        fq = model.get_submodule(".".join(path_str.split("/")))
        if not isinstance(fq, FakeQuantize):
            raise ValueError(f"{path_str} is a {type(fq).__name__}, not a FakeQuantize")
        want_shape = tuple(fq.scale.shape)

        scale = np.asarray(_np(state_dict[f"{prefix}.scale"]), np.float32).reshape(-1)
        if scale.shape != want_shape and scale.size == 1:
            scale = np.broadcast_to(scale, want_shape)
        if scale.shape != want_shape:
            raise ValueError(f"{path_str}: scale shape {scale.shape} != {want_shape}")

        if f"{prefix}.shift" in state_dict:
            shift = np.asarray(_np(state_dict[f"{prefix}.shift"]), np.float32).reshape(-1)
        elif f"{prefix}.zero_point" in state_dict:
            zp = np.asarray(_np(state_dict[f"{prefix}.zero_point"]), np.float32).reshape(-1)
            shift = -zp * scale
        else:
            shift = fq.shift.detach().cpu().numpy()
        if shift.shape != want_shape and shift.size == 1:
            shift = np.broadcast_to(shift, want_shape)

        fq.scale.copy_(torch.from_numpy(np.ascontiguousarray(scale, np.float32)))
        fq.shift.copy_(torch.from_numpy(np.ascontiguousarray(shift, np.float32)))
        for flag in _FLAG_KEYS:
            key = f"{prefix}.{flag}"
            if key in state_dict:
                getattr(fq, flag).fill_(bool(_np(state_dict[key]).reshape(-1)[0]))
        if f"{prefix}.current_batch" in state_dict:
            fq.current_batch.fill_(int(_np(state_dict[f"{prefix}.current_batch"]).reshape(-1)[0]))
        fq.invalidate_host_state()
    return model
