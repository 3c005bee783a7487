"""QAT train and eval steps on one device (port of ``make_train_step``,
``make_eval_step`` and ``cross_entropy_loss`` of ``jaxlsq/parallel/train.py``,
without a mesh and with ``accum_steps=1``).

One step is: the training forward (the observers write the quantizers'
scale/shift in place while they run), the backward, then
``optimizer.step()``.  So the optimizer's update lands on top of the
observer-written qparams, the JAX package's train-step contract: while an
observer drives a quantizer its qparams' gradients are exactly zero (the
eval-mode backward), and once LSQ learning starts the observer no longer
writes.  ``torch.optim.SGD(params, lr, momentum=m)`` keeps the trace
``t = g + m·t`` and applies ``−lr·t``, first step ``t = g``, as
``optax.sgd(lr, momentum=m)`` does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import FakeQuantize

__all__ = ["make_train_step", "make_eval_step", "cross_entropy_loss"]


def cross_entropy_loss(logits: torch.Tensor, batch: Dict) -> torch.Tensor:
    """Mean softmax cross entropy against integer ``batch['label']``."""
    return F.cross_entropy(logits, batch["label"])


def _inputs(batch: Dict) -> torch.Tensor:
    return batch["input"] if "input" in batch else batch["image"]


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable = cross_entropy_loss):
    """``step(batch) -> {"loss": loss}`` (loss a device scalar, not synced),
    updating ``model`` and ``optimizer`` in place.  ``batch`` holds
    'image' or 'input' (fed to the model) and what ``loss_fn`` needs.

    A parameter that took no gradient (a quantizer whose fake quantization
    is off) gets a zero gradient, as JAX's gradient of an unused input is
    zero, so its momentum trace decays as optax's does.
    """
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.train()
        loss = loss_fn(model(_inputs(batch)), batch)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return {"loss": loss.detach()}

    return step


@contextlib.contextmanager
def _quant_state_frozen(model: nn.Module):
    fqs = [m for m in model.modules() if isinstance(m, FakeQuantize)]
    for m in fqs:
        m.persist_state = False
    try:
        yield
    finally:
        for m in fqs:
            m.persist_state = True


def make_eval_step(model: nn.Module):
    """``step(batch) -> logits``: the eval-mode forward with no gradient, and
    nothing of the quantizers' state kept, as the JAX package's eval step
    discards its mutated collections."""

    def step(batch: Dict) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad(), _quant_state_frozen(model):
                return model(_inputs(batch))
        finally:
            model.train(was_training)

    return step
