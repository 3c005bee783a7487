"""QAT train and eval steps (port of ``make_train_step``, ``make_eval_step``
and ``cross_entropy_loss`` of ``jaxlsq/parallel/train.py``), on one device
or over a mesh of processes (``mesh=``: jaxlsq's one-device step on the
global batch; see ``make_train_step``).

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
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import _dist
from .placement import apply_sharding, gathered_params
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


class _Mesh:
    """What a step under a mesh needs: the split of the rows, the groups
    each parameter's gradient is summed over, the mesh's size."""

    def __init__(self, model: nn.Module, mesh, sequence_axis: Optional[str]):
        names = list(mesh.mesh_dim_names)
        if "data" not in names:
            raise ValueError(f"the mesh needs a 'data' axis, has {names}")
        if sequence_axis is not None and sequence_axis not in names:
            raise ValueError(f"sequence_axis {sequence_axis!r} is not a mesh axis {names}")

        def part(name, dim):
            i = names.index(name)
            return _dist.Part(mesh.get_group(i), mesh.size(i),
                              mesh.get_local_rank(name), dim)

        parts = [part("data", 0)]
        self.seq = None
        if sequence_axis is not None:
            self.seq = part(sequence_axis, 1)
            parts.append(self.seq)
        self.data = parts[0]
        self.split = _dist.Split(tuple(parts))
        self.groups = {n: mesh.get_group(i) for i, n in enumerate(names)}
        self.size = mesh.size()
        self.model = model
        self._plans = {}  # regroup's row order and split sizes, by batch shape
        # a sharded leaf's gradient is summed over the axes it is not
        # sharded on (an FSDP shard's over the sharded one too, by the
        # reduce-scatter of its all-gather's backward)
        named = dict(model.named_parameters())
        self.owned = {}
        for table in (getattr(model, "_jlt_fsdp", {}), getattr(model, "_jlt_expert", {})):
            for name, pt in table.items():
                if name in named:
                    self.owned[id(named[name])] = pt.group

    def reduce_grads(self, params) -> None:
        """Every gradient summed over its groups and divided by the mesh's
        size: the gradient of the global mean loss.  One flat all-reduce a
        group per bucket of parameters with the same groups."""
        buckets = {}
        for p in params:
            skip = self.owned.get(id(p))
            key = tuple(n for n, g in self.groups.items() if g is not skip)
            buckets.setdefault(key, []).append(p)
        for key, ps in buckets.items():
            for i in range(0, len(ps), _BUCKET):
                chunk = ps[i:i + _BUCKET]
                flat = torch.cat([p.grad.reshape(-1) for p in chunk])
                for n in key:
                    _dist.all_reduce(flat, "sum", self.groups[n])
                flat.div_(float(self.size))
                _unflat([p.grad for p in chunk], flat)

    def mean(self, loss: torch.Tensor) -> torch.Tensor:
        loss = loss.detach().clone().reshape(())
        for g in self.groups.values():
            _dist.all_reduce(loss, "sum", g)
        return loss / float(self.size)

    def forward(self, x: torch.Tensor, grad: bool = True) -> torch.Tensor:
        if getattr(self.model, "_jlt_fsdp", None):
            return torch.func.functional_call(self.model, gathered_params(self.model, grad),
                                              (x,), strict=False)
        return self.model(x)

    def loss_batch(self, batch: Dict) -> Dict:
        """The batch ``loss_fn`` sees: under sequence parallelism each
        tensor's dim 1 gathered over the sequence axis."""
        if self.seq is None:
            return batch
        return {k: (_dist.all_gather(v, self.seq.group, self.seq.size, 1)
                    if torch.is_tensor(v) and v.dim() >= 2 else v)
                for k, v in batch.items()}

    def regroup(self, batch: Dict, n: int) -> Dict:
        """jaxlsq's microbatch i is the global rows [i B / n, (i + 1) B / n);
        one all-to-all of rows a tensor gives this process its 1/W of each,
        in order, so ``_microbatches`` cuts them out."""
        part = self.data
        b, w, r = _inputs(batch).shape[0], part.size, part.rank
        m = b * w // n
        if (b * w) % n or m % w:
            raise ValueError(f"a global batch of {b * w} rows does not split into "
                             f"{n} microbatches over {w} processes")

        device = _inputs(batch).device
        key = (b, n, device)
        if key not in self._plans:  # made at an eager call, before any capture
            def dest(g):  # the process that holds global row g in its microbatch
                return (g % m) // (m // w)

            rows = [(dest(r * b + l), l) for l in range(b)]
            send = [sum(1 for q, _ in rows if q == k) for k in range(w)]
            recv = [sum(1 for l in range(b) if dest(s * b + l) == r) for s in range(w)]
            idx = torch.tensor([l for _, l in sorted(rows)], device=device)
            self._plans[key] = (idx, send, recv)
        idx, send, recv = self._plans[key]
        return {k: _dist.all_to_all_rows(v.index_select(0, idx), send, recv, part.group)
                for k, v in batch.items()}


# parameters per flat gradient all-reduce
_BUCKET = 256


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable = cross_entropy_loss, jit: bool = True,
                    accum_steps: int = 1, mesh=None, donate: bool = True,
                    state_sharding=None, sequence_axis: Optional[str] = None):
    """``step(batch) -> {"loss": loss}`` (loss a device scalar, not synced),
    updating ``model`` and ``optimizer`` in place.  ``batch`` is a dict of
    tensors: 'image' or 'input' (fed to the model) and what ``loss_fn``
    needs, each with the batch as its leading axis.

    A parameter that took no gradient (in the eager regime, a quantizer
    whose fake quantization is off) gets a zero gradient, as JAX's gradient
    of an unused input is zero, so its momentum trace decays as optax's
    does.  In the traced regime every quantizer's qparams take a gradient.

    ``mesh`` (``parallel.make_mesh``): every process of the mesh calls the
    step on its part of the global batch (``shard_batch``), and the step is
    jaxlsq's one-device step on the global batch: the activation
    quantizers' gradient scale counts the global elements, the observers,
    BatchNorm, the MoE routing and its load-balance loss see the global
    batch (``jaxlsq_torch._dist``), the gradients are averaged over the
    mesh in a few flat all-reduces, and the loss returned is the global
    one.  ``state_sharding`` (``fsdp_sharding``, ``moe_sharding``) is put in
    effect first (``apply_sharding``); an FSDP step needs ``jit=False``.
    ``sequence_axis`` (a mesh axis, jaxlsq's ``P('data', 'model')`` batch
    spec) splits each tensor's dim 1 over it as well: sequence parallelism
    of the LM, ``loss_fn`` seeing the logits and batch gathered over that
    axis.  ``accum_steps`` takes jaxlsq's global microbatches.  ``donate``
    is jaxlsq's argument and changes nothing here (the step updates the
    model in place).  On a card, ``jit=True`` captures the collectives in
    the step's graph, which needs the NCCL backend.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    del donate
    mesh_ctx = None
    if mesh is not None:
        if state_sharding is not None:
            apply_sharding(model, state_sharding, mesh, optimizer)
        if jit and getattr(model, "_jlt_fsdp", None):
            raise ValueError("make_train_step(jit=True) does not take an FSDP-sharded "
                             "state: build the FSDP step with jit=False")
        if sequence_axis is not None and accum_steps > 1:
            raise ValueError("accum_steps > 1 with sequence_axis is not supported")
        if (jit and next(model.parameters()).device.type == "cuda"
                and dist.get_backend() != "nccl"):
            raise ValueError("make_train_step(jit=True) on a card captures the step's "
                             "collectives in a CUDA graph, which the "
                             f"{dist.get_backend()!r} backend cannot; use NCCL or "
                             "jit=False")
        mesh_ctx = _Mesh(model, mesh, sequence_axis)
    elif state_sharding is not None or sequence_axis is not None:
        raise ValueError("state_sharding and sequence_axis need a mesh")
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
        if mesh_ctx is None:
            with collect_losses() as terms:
                out = model(_inputs(batch))
            loss = loss_fn(out, batch)
        else:
            with _dist.splitting(mesh_ctx.split), collect_losses() as terms:
                out = mesh_ctx.forward(_inputs(batch))
                if mesh_ctx.seq is not None:
                    out = _dist.all_gather_grad(out, mesh_ctx.seq.group,
                                                mesh_ctx.seq.size, 1)
            loss = loss_fn(out, mesh_ctx.loss_batch(batch))
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
            if mesh_ctx is not None:
                batch = mesh_ctx.regroup(batch, accum_steps)
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
        if mesh_ctx is not None:
            mesh_ctx.reduce_grads(params)
            loss = mesh_ctx.mean(loss)
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


def make_eval_step(model: nn.Module, mesh=None, state_sharding=None):
    """``step(batch) -> logits``: the eval-mode forward with no gradient, and
    nothing of the quantizers' state kept, as the JAX package's eval step
    discards its mutated collections.  With ``mesh`` each process passes
    its part of the global batch (``shard_batch``) and gets the logits of
    its rows, computed as on the global batch (an observer still in its
    window, the MoE routing); ``state_sharding`` is put in effect first."""
    fqs = _quantizers(model)
    mesh_ctx = None
    if mesh is not None:
        if state_sharding is not None:
            apply_sharding(model, state_sharding, mesh)
        mesh_ctx = _Mesh(model, mesh, None)

    def step(batch: Dict) -> torch.Tensor:
        was_training = model.training
        model.eval()
        refresh_host_state(fqs)
        try:
            with torch.no_grad(), quant_state_frozen(fqs):
                if mesh_ctx is None:
                    return model(_inputs(batch))
                with _dist.splitting(mesh_ctx.split):
                    return mesh_ctx.forward(_inputs(batch), grad=False)
        finally:
            model.train(was_training)

    return step
