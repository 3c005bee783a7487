"""Model-wide QAT mode toggles (port of ``jaxlsq/models/toggles.py``).

The JAX package's toggles walk a variables pytree and return a new one with
the mode flags flipped inside every quantizer's ``quant_state``; here they
walk an ``nn.Module`` and write the flags of every :class:`FakeQuantize` in
place (``fill_``/``copy_`` into its buffers), so a step captured as a CUDA
graph sees the new flags at its next replay, and the eager regime's host
mirror at its next forward.  Each returns the module.

The act/weight-filtered variants select quantizers by their module name
(``act_fq`` / ``weight_fq``, as QuantDense and QuantConv name them), the JAX
package's structural filter.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..observers.quantizer import STATE_FIELDS
from .layers import FakeQuantize

__all__ = [
    "enable_fake_quant", "disable_fake_quant",
    "enable_observer", "disable_observer",
    "enable_fake_quant_on_act", "disable_fake_quant_on_act",
    "enable_observer_on_weights", "disable_observer_on_weights",
    "map_quant_state",
]

@torch.no_grad()
def _write(dst: torch.Tensor, value) -> None:
    if value is dst:
        return
    if torch.is_tensor(value):
        dst.copy_(value)
    else:
        dst.fill_(value)


def map_quant_state(model: nn.Module,
                    fn: Callable[[Dict[str, Any]], Dict[str, Any]],
                    name_filter: Optional[str] = None) -> nn.Module:
    """Apply ``fn`` to every quantizer's state in ``model``.  ``fn`` takes
    the JAX package's quant_state dict (``current_batch``, ``n_batches``,
    the three ``*_enabled`` flags and ``obs`` = {``min_val``, ``max_val``,
    ``seen``, and a histogram observer's ``histogram``}) holding the
    module's buffers, and returns the new dict; each entry it changed (a
    tensor or a number) is written into its buffer in place.  ``name_filter`` restricts to quantizers whose module path has
    that name (e.g. 'act_fq' or 'weight_fq')."""
    for name, mod in model.named_modules():
        if not isinstance(mod, FakeQuantize):
            continue
        if name_filter is not None and name_filter not in name.split("."):
            continue
        obs = mod.obs_buffers()
        qs = {f: getattr(mod, f) for f in STATE_FIELDS}
        qs["obs"] = dict(obs)
        new = fn(dict(qs))
        for f in STATE_FIELDS:
            _write(getattr(mod, f), new[f])
        for k, b in obs.items():
            _write(b, new["obs"][k])
    return model


def _set_flag(flag: str, value: bool, name_filter: Optional[str] = None):
    def toggle(model: nn.Module) -> nn.Module:
        return map_quant_state(model, lambda qs: {**qs, flag: value},
                               name_filter=name_filter)
    return toggle


def enable_fake_quant(model: nn.Module) -> nn.Module:
    return _set_flag("fake_quant_enabled", True)(model)


def disable_fake_quant(model: nn.Module) -> nn.Module:
    return _set_flag("fake_quant_enabled", False)(model)


def enable_observer(model: nn.Module) -> nn.Module:
    return _set_flag("observer_enabled", True)(model)


def disable_observer(model: nn.Module) -> nn.Module:
    return _set_flag("observer_enabled", False)(model)


def enable_fake_quant_on_act(model: nn.Module) -> nn.Module:
    return _set_flag("fake_quant_enabled", True, "act_fq")(model)


def disable_fake_quant_on_act(model: nn.Module) -> nn.Module:
    return _set_flag("fake_quant_enabled", False, "act_fq")(model)


def enable_observer_on_weights(model: nn.Module) -> nn.Module:
    return _set_flag("observer_enabled", True, "weight_fq")(model)


def disable_observer_on_weights(model: nn.Module) -> nn.Module:
    return _set_flag("observer_enabled", False, "weight_fq")(model)
