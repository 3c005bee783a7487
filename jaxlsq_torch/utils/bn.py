"""BatchNorm statistics re-estimation after QAT (port of
``jaxlsq/utils/bn.py``).

QAT leaves each BatchNorm's running statistics a momentum-lagged average
taken while the weights and the quantizer scales still moved; re-estimation
runs the final quantized network in training mode over calibration batches
and updates only the BatchNorm statistics: the port's flax-rule
``BatchNorm``'s ``mean``/``var``, and a stock ``nn.BatchNorm*d``'s
``running_mean``/``running_var`` under its own rule (its momentum; the
unbiased batch variance), as in a stock model that ``quantize_model``
swapped.  The JAX package runs it as one ``lax.scan`` with only
``batch_stats`` mutable, so the quantizers compute
in training mode but their state writes are dropped; here the quantizers
write in place, so the loop runs them with their state frozen
(``quant_state_frozen``): each batch's forward is the training forward of the
state as it stands, and no quantizer parameter or buffer changes.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm

from ..models.layers import FakeQuantize, quant_state_frozen, refresh_host_state
from ..models.norm import BatchNorm

__all__ = ["reestimate_batch_stats"]


@torch.no_grad()
def reestimate_batch_stats(model: nn.Module, inputs: Iterable[torch.Tensor]) -> None:
    """Refresh the running statistics of every ``BatchNorm`` and stock
    ``nn.BatchNorm*d`` of ``model`` in place by running it in training mode
    over ``inputs``: an iterable of batches (a stacked (N, B, ...) tensor
    gives its N batches).  With the flax-rule momentum of 0.99, N >= ~300
    batches leave < 5% weight on the old statistics.  Every quantizer
    parameter and buffer stays as it was; the model's training flag is
    restored."""
    if not any(isinstance(m, (BatchNorm, _BatchNorm)) for m in model.modules()):
        return
    fqs = [m for m in model.modules() if isinstance(m, FakeQuantize)]
    was_training = model.training
    model.train()
    refresh_host_state(fqs)
    try:
        with quant_state_frozen(fqs):
            for x in inputs:
                model(x)
    finally:
        model.train(was_training)
