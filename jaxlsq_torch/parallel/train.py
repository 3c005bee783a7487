"""QAT train and eval steps on one device (port of ``make_train_step``,
``make_eval_step`` and ``cross_entropy_loss`` of ``jaxlsq/parallel/train.py``,
without a mesh).

One step is: the training forward (the observers write the quantizers'
scale/shift in place while they run), the backward, then
``optimizer.step()``.  So the optimizer's update lands on top of the
observer-written qparams, the JAX package's train-step contract: while an
observer drives a quantizer its qparams' gradients are exactly zero, and
once LSQ learning starts the observer no longer writes.
``torch.optim.SGD(params, lr, momentum=m)`` keeps the trace ``t = g + m·t``
and applies ``−lr·t``, first step ``t = g``, as ``optax.sgd(lr,
momentum=m)`` does.

``jit`` picks the regime, as ``jax.jit`` does in the JAX package:

* ``jit=False``: the quantizers' eager regime (phase decided on the host,
  the static fake-quant kernels); every call runs eagerly.
* ``jit=True``: the traced regime (phase decided by device values, the
  traced fake-quant kernels).  On a CUDA model the first call with a batch
  shape is one eager step on a side stream (it makes SGD's momentum buffers
  and loads every kernel), the second captures the whole step (forward,
  backward and ``optimizer.step()``) as one CUDA graph and replays it, and
  later calls copy the batch into the graph's static input and replay.  The
  observer-window → LSQ switch and the toggles (``models.toggles``) act
  through device flags, without a new capture.  On the CPU there is no
  capture: the same traced program runs eagerly.

``accum_steps > 1`` splits the batch's leading axis into that many
microbatches, run in order (observers and BatchNorm see each one); the
gradients are summed in ``.grad`` and divided by ``accum_steps``, the loss
is the mean of the microbatch losses, and one update lands on the last
observer-written qparams.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import FakeQuantize, refresh_host_state

__all__ = ["make_train_step", "make_eval_step", "cross_entropy_loss"]


def cross_entropy_loss(logits: torch.Tensor, batch: Dict) -> torch.Tensor:
    """Mean softmax cross entropy over the LAST axis of ``logits`` against
    integer ``batch['label']`` of the leading shape: (B, C) class logits or
    (B, t, V) LM logits alike, as optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch["label"].reshape(-1))


def _inputs(batch: Dict) -> torch.Tensor:
    return batch["input"] if "input" in batch else batch["image"]


def _quantizers(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, FakeQuantize)]


@contextlib.contextmanager
def _traced(fqs):
    for m in fqs:
        m.traced = True
    try:
        yield
    finally:
        for m in fqs:
            m.traced = False


def _microbatches(batch: Dict, n: int):
    size = _inputs(batch).shape[0]
    if size % n:
        raise ValueError(f"batch of {size} does not split into {n} microbatches")
    m = size // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()} for i in range(n)]


class _CapturedStep:
    """``step(batch)`` of a CUDA model: per batch signature, one eager
    warm-up step, then one capture, then replays."""

    def __init__(self, body: Callable, fqs, device: torch.device):
        self.body, self.fqs, self.device = body, fqs, device
        self.graphs = {}  # signature -> None (warmed up) or (graph, batch, loss)

    def __call__(self, batch: Dict) -> Dict[str, torch.Tensor]:
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))
        if key not in self.graphs:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), _traced(self.fqs):
                loss = self.body(batch)
            torch.cuda.current_stream().wait_stream(side)
            self.graphs[key] = None
            return {"loss": loss}
        entry = self.graphs[key]
        if entry is None:
            static = {k: v.to(self.device, copy=True) for k, v in batch.items()}
            graph = torch.cuda.CUDAGraph()
            with _traced(self.fqs), torch.cuda.graph(graph):
                loss = self.body(static)
            entry = self.graphs[key] = (graph, static, loss)
        else:
            for k, v in batch.items():
                entry[1][k].copy_(v)
        entry[0].replay()
        for m in self.fqs:
            m.invalidate_host_state()
        return {"loss": entry[2].clone()}


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable = cross_entropy_loss, jit: bool = True,
                    accum_steps: int = 1):
    """``step(batch) -> {"loss": loss}`` (loss a device scalar, not synced),
    updating ``model`` and ``optimizer`` in place.  ``batch`` is a dict of
    tensors: 'image' or 'input' (fed to the model) and what ``loss_fn``
    needs, each with the batch as its leading axis.

    A parameter that took no gradient (in the eager regime, a quantizer
    whose fake quantization is off) gets a zero gradient, as JAX's gradient
    of an unused input is zero, so its momentum trace decays as optax's
    does.  In the traced regime every quantizer's qparams take a gradient.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    params = [p for group in optimizer.param_groups for p in group["params"]]
    fqs = _quantizers(model)

    def body(batch: Dict) -> torch.Tensor:
        model.train()
        if accum_steps == 1:
            loss = loss_fn(model(_inputs(batch)), batch)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        else:
            optimizer.zero_grad(set_to_none=True)
            losses = []
            for mb in _microbatches(batch, accum_steps):
                loss = loss_fn(model(_inputs(mb)), mb)
                loss.backward()
                losses.append(loss.detach())
            loss = torch.stack(losses).mean()
            for p in params:
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return loss.detach()

    if not jit:
        def eager_step(batch: Dict) -> Dict[str, torch.Tensor]:
            refresh_host_state(fqs)
            return {"loss": body(batch)}
        return eager_step

    device = next(model.parameters()).device
    if device.type == "cuda":
        return _CapturedStep(body, fqs, device)

    def traced_step(batch: Dict) -> Dict[str, torch.Tensor]:
        with _traced(fqs):
            return {"loss": body(batch)}
    return traced_step


@contextlib.contextmanager
def _quant_state_frozen(fqs):
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
    fqs = _quantizers(model)

    def step(batch: Dict) -> torch.Tensor:
        was_training = model.training
        model.eval()
        refresh_host_state(fqs)
        try:
            with torch.no_grad(), _quant_state_frozen(fqs):
                return model(_inputs(batch))
        finally:
            model.train(was_training)

    return step
