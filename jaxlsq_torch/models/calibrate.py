"""Post-training calibration (port of ``jaxlsq/models/calibrate.py``): the
static-estimate mode (a plain FakeQuantize driven by its observer, no LSQ
learning) as one call::

    calibrate(model, batches)                       # observers track ranges
    served.load_variables(...)                       # or convert and serve

Every quantizer is switched to static estimate (learning off, observer on),
then the batches run through the model in eval mode with the quantizers'
state kept, so the observers see real activation ranges and write the
qparams; BatchNorm uses and keeps its running statistics.  The quantizers
are left in static estimate (``enable_param_learning_all`` hands them to
LSQ QAT instead).  A quantizer with no observer (an ``init_mode=
'learnable'`` activation quantizer, a weight quantizer) keeps its qparams:
calibration is a silent no-op there, as in the JAX package.

Each function updates ``model`` in place (``models.toggles.map_quant_state``)
and returns it.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

from .toggles import map_quant_state

__all__ = ["calibrate", "set_static_estimate", "enable_param_learning_all"]


def set_static_estimate(model: nn.Module) -> nn.Module:
    """Every quantizer to static estimate: observer on, LSQ learning off."""
    return map_quant_state(model, lambda qs: {**qs, "learning_enabled": False,
                                              "observer_enabled": True})


def enable_param_learning_all(model: nn.Module) -> nn.Module:
    """Every quantizer to full LSQ learning: observer off, no init window."""
    return map_quant_state(model, lambda qs: {**qs, "learning_enabled": True,
                                              "observer_enabled": False,
                                              "n_batches": -1})


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable, *, input_key: str = "input"
              ) -> nn.Module:
    """Run ``batches`` (tensors, or dicts holding ``input_key``) through
    ``model`` in static-estimate mode, eval mode, keeping what the observers
    write."""
    set_static_estimate(model)
    was_training = model.training
    model.eval()
    try:
        for batch in batches:
            model(batch[input_key] if isinstance(batch, dict) else batch)
    finally:
        model.train(was_training)
    return model
