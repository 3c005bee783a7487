"""QAT train and eval steps on one device (port of ``make_train_step``,
``make_eval_step`` and ``cross_entropy_loss`` of ``jaxlsq/parallel/train.py``,
without a mesh).

One step is: the training forward (the observers write the quantizers'
scale/shift in place while they run), the backward, then
``optimizer.step()``.  The update lands on top of the observer-written
qparams, but is computed from the qparams the step started with, as the JAX
package's ``apply_updates(observer_params, update(grads, old_params))``:
the step keeps each observed qparam's value before the forward (``old``) and
after the backward (``new``), puts ``old`` back for ``optimizer.step()``
and then writes ``new + (stepped − old)`` where ``new != old``.  So weight
decay acts on ``old``, as optax's does; where the observer wrote nothing
(outside the observer window) the result is the optimizer's own, bit for
bit.  While an observer drives a quantizer its qparams' gradients are
exactly zero, and once LSQ learning starts the observer no longer writes.
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

  The learning rate stays live across replays where the optimizer reads it
  from the device: with ``capturable=True`` (Adam, AdamW) or ``fused=True``
  (SGD), each param group's ``lr`` becomes a 0-d f32 device tensor before
  the warm-up, and before every replay the group's current value (a Python
  float a scheduler wrote, or another tensor) is copied into it on the
  replaying stream.  An optimizer with ``capturable=False`` raises.  Any
  other (an SGD without ``fused=True``) keeps the lr it was captured with,
  and a later change to it raises rather than replay the old value.  Every
  other hyperparameter (momentum, weight decay, betas, ...) is frozen at
  capture: a change raises before the next replay.

``accum_steps > 1`` splits the batch's leading axis into that many
microbatches, run in order (observers and BatchNorm see each one); the
gradients are summed in ``.grad`` and divided by ``accum_steps``, the loss
is the mean of the microbatch losses, and one update lands on the last
observer-written qparams.

The objective of a forward is ``loss_fn(logits, batch)`` plus the terms its
modules recorded with ``models.layers.sow_loss`` in that forward (the JAX
package's ``losses`` collection; each term's sum counts, and a term of an
earlier forward never does); under ``accum_steps`` each microbatch's own,
under capture inside the graph.  :func:`distillation_loss` builds a
``loss_fn`` that adds a KL term against a frozen float teacher.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import (FakeQuantize, collect_losses, quant_state_frozen,
                             refresh_host_state)

__all__ = ["make_train_step", "make_eval_step", "cross_entropy_loss",
           "distillation_loss"]


def cross_entropy_loss(logits: torch.Tensor, batch: Dict) -> torch.Tensor:
    """Mean softmax cross entropy over the LAST axis of ``logits`` against
    integer ``batch['label']`` of the leading shape: (B, C) class logits or
    (B, t, V) LM logits alike, as optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch["label"].reshape(-1))


def distillation_loss(teacher: nn.Module, *, alpha: float = 0.5,
                      temperature: float = 2.0,
                      hard_loss: Callable = cross_entropy_loss) -> Callable:
    """A ``loss_fn`` for :func:`make_train_step` (the JAX package's
    ``distillation_loss``): ``alpha * hard_loss(logits, batch) + (1 - alpha)
    * T² * KL(softmax(teacher / T) || softmax(student / T))``, the KL as
    ``sum(exp(p_t) * (p_t - p_s))`` over the last axis of the log-softmaxes
    at T, meaned over the rest.  The teacher (on the student's device) runs
    its eval forward on the batch's 'input' or 'image' with no gradient and
    nothing of its state kept (``make_eval_step``); it is in no optimizer.
    ``alpha == 1`` runs no teacher forward.  Under ``make_train_step(jit=True)``
    on the card the teacher's forward is captured in the step's graph."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    t = float(temperature)
    teacher_logits = make_eval_step(teacher)

    def loss_fn(logits: torch.Tensor, batch: Dict) -> torch.Tensor:
        loss = alpha * hard_loss(logits, batch) if alpha > 0.0 else 0.0
        if alpha == 1.0:
            return loss
        p_t = F.log_softmax(teacher_logits(batch) / t, dim=-1)
        p_s = F.log_softmax(logits / t, dim=-1)
        kl = torch.sum(torch.exp(p_t) * (p_t - p_s), dim=-1).mean()
        return loss + (1.0 - alpha) * (t * t) * kl

    return loss_fn


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


def _flat(params):
    """The parameters' values as one new flat tensor (one kernel)."""
    if not params:
        return None
    return torch.cat([p.detach().reshape(-1) for p in params])


@torch.no_grad()
def _unflat(params, flat) -> None:
    """Write ``_flat``'s layout back into the parameters in place."""
    if params:
        torch._foreach_copy_(params, [c.view_as(p) for c, p in zip(
            flat.split([p.numel() for p in params]), params)])


def _microbatches(batch: Dict, n: int):
    size = _inputs(batch).shape[0]
    if size % n:
        raise ValueError(f"batch of {size} does not split into {n} microbatches")
    m = size // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()} for i in range(n)]


def _reads_device_lr(group: Dict) -> bool:
    return bool(group.get("capturable")) or bool(group.get("fused"))


class _Hyper:
    """An optimizer's hyperparameters as a captured step holds them: the
    device ``lr`` of each group that reads one, and the values frozen at
    capture."""

    def __init__(self, optimizer: torch.optim.Optimizer, device: torch.device):
        self.opt = optimizer
        self.lrs = []  # per group: its 0-d f32 device lr, or None (host lr)
        for group in optimizer.param_groups:
            if not _reads_device_lr(group):
                if "capturable" in group:
                    raise ValueError(
                        f"make_train_step(jit=True): {type(optimizer).__name__} "
                        "with capturable=False cannot run inside a captured CUDA "
                        "graph; construct it with capturable=True")
                self.lrs.append(None)
                continue
            lr = group["lr"]
            if not (torch.is_tensor(lr) and lr.device == device and lr.dim() == 0
                    and lr.dtype == torch.float32):
                lr = torch.tensor(float(lr), dtype=torch.float32, device=device)
                group["lr"] = lr
            self.lrs.append(lr)
        self.frozen = None

    def _held(self, group: Dict, lr) -> Dict:
        skip = ("params", "initial_lr") + (("lr",) if lr is not None else ())
        return {k: v for k, v in group.items() if k not in skip}

    def freeze(self) -> None:
        """Hold the values the graph about to be captured bakes in."""
        self.frozen = [self._held(g, lr)
                       for g, lr in zip(self.opt.param_groups, self.lrs)]

    def sync(self) -> None:
        """Before a replay: raise on a changed frozen value; copy each
        group's lr into its device tensor (on the current stream)."""
        groups = self.opt.param_groups
        if len(groups) != len(self.lrs):
            raise RuntimeError("make_train_step(jit=True): the optimizer's param "
                               "groups changed after the step was captured")
        for i, (group, lr, held) in enumerate(zip(groups, self.lrs, self.frozen)):
            now = self._held(group, lr)
            for k in held.keys() | now.keys():
                a, b = held.get(k), now.get(k)
                same = a is b if torch.is_tensor(a) or torch.is_tensor(b) else a == b
                if same:
                    continue
                hint = ("construct the optimizer with fused=True (SGD) or "
                        "capturable=True (Adam, AdamW) so a captured step reads "
                        "its lr from the device" if k == "lr" else
                        "only lr may change between replays")
                raise RuntimeError(
                    f"make_train_step(jit=True): param group {i}'s {k!r} changed "
                    f"from {a!r} to {b!r} after the step was captured, and the "
                    f"graph would replay the old value; {hint}")
            cur = group["lr"]
            if lr is not None and cur is not lr:
                if torch.is_tensor(cur):
                    lr.copy_(cur.reshape(()))
                else:
                    lr.fill_(float(cur))
                group["lr"] = lr


class _CapturedStep:
    """``step(batch)`` of a CUDA model: per batch signature, one eager
    warm-up step, then one capture, then replays."""

    def __init__(self, body: Callable, fqs, device: torch.device,
                 optimizer: torch.optim.Optimizer):
        self.body, self.fqs, self.device = body, fqs, device
        self.optimizer = optimizer
        self.hyper = None  # made at the first call
        self.graphs = {}  # signature -> None (warmed up) or (graph, batch, loss)

    def __call__(self, batch: Dict) -> Dict[str, torch.Tensor]:
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))
        if self.hyper is None:
            self.hyper = _Hyper(self.optimizer, self.device)
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
            if self.hyper.frozen is None:
                self.hyper.freeze()
            self.hyper.sync()
            static = {k: v.to(self.device, copy=True) for k, v in batch.items()}
            graph = torch.cuda.CUDAGraph()
            with _traced(self.fqs), torch.cuda.graph(graph):
                loss = self.body(static)
            entry = self.graphs[key] = (graph, static, loss)
        else:
            self.hyper.sync()
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
    in_opt = {id(p) for p in params}
    # the qparams an observer may write: in the traced regime every observed
    # quantizer's (a device flag decides), in the eager one those whose
    # observer the host mirror shows on (read after refresh_host_state)
    observed = [m for m in fqs if m.cfg.observer is not None and not m.cfg.debug_mode]

    def observed_qparams():
        mods = observed if jit else [m for m in observed
                                     if m.host_state()["observer_enabled"]]
        return [p for m in mods for p in (m.scale, m.shift) if id(p) in in_opt]

    def objective(batch: Dict) -> torch.Tensor:
        with collect_losses() as terms:
            out = model(_inputs(batch))
        loss = loss_fn(out, batch)
        if terms:  # the JAX package's reduce(add, sums, zeros) over 'losses'
            aux = torch.zeros((), dtype=torch.float32, device=loss.device)
            for term in terms:
                aux = aux + term.sum()
            loss = loss + aux
        return loss

    def body(batch: Dict) -> torch.Tensor:
        model.train()
        qps = observed_qparams()
        old = _flat(qps)
        if accum_steps == 1:
            loss = objective(batch)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        else:
            optimizer.zero_grad(set_to_none=True)
            losses = []
            for mb in _microbatches(batch, accum_steps):
                loss = objective(mb)
                loss.backward()
                losses.append(loss.detach())
            loss = torch.stack(losses).mean()
            for p in params:
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        new = _flat(qps)
        _unflat(qps, old)
        optimizer.step()
        if qps:  # new + update, the update taken at old
            stepped = _flat(qps)
            _unflat(qps, torch.where(new == old, stepped, new + (stepped - old)))
        return loss.detach()

    if not jit:
        def eager_step(batch: Dict) -> Dict[str, torch.Tensor]:
            refresh_host_state(fqs)
            return {"loss": body(batch)}
        return eager_step

    device = next(model.parameters()).device
    if device.type == "cuda":
        return _CapturedStep(body, fqs, device, optimizer)

    def traced_step(batch: Dict) -> Dict[str, torch.Tensor]:
        with _traced(fqs):
            return {"loss": body(batch)}
    return traced_step


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
            with torch.no_grad(), quant_state_frozen(fqs):
                return model(_inputs(batch))
        finally:
            model.train(was_training)

    return step
