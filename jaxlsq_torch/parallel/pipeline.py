"""Pipeline-parallel QAT training of the quantized transformer LM (port of
``jaxlsq/parallel/pipeline.py``): GPipe over a 'stage' axis of
``torch.distributed``, composed with a 'data' axis.

jaxlsq restacks the LM's blocks into (S, depth/S, ...) slabs sharded over
'stage' and runs the whole schedule as one SPMD program: a ``lax.scan`` over
MB + S − 1 ticks with a ``ppermute`` a tick, differentiated whole.  Here
each process holds a :class:`PipelineStage` module, its own depth/S blocks
beside replicas of the embed, ``pos_emb``, ``ln_f`` and the head, and the
step is scheduled by hand with point-to-point sends on the 'stage' group:

* forward: microbatch j enters stage s after stage s − 1 sent it; stage 0
  embeds it, every stage runs its blocks and sends the activation on, the
  last stage runs ``ln_f``, the head and ``loss_fn`` on it;
* backward, microbatch by microbatch in the same order: the last stage from
  its loss, every other stage from the activation gradient received from
  s + 1, each sending its input's gradient back to s − 1.

There are no bubble ticks: a stage with nothing to do waits in its receive,
so nothing is computed to be masked away.

The quantizers keep jaxlsq's pipeline semantics (:class:`MicrobatchTape`):
each stage's quantizers see its microbatches in submission order and
advance their counters and observers once per microbatch; each
microbatch's backward uses the qparams its forward used; an observer's
write reaches the later microbatches as a constant, so their scale
gradients wait for the next step (``pipeline.py:29-35``).  Every backward
runs after all the forwards, so these snapshots are what keeps a later
microbatch's write from reaching an earlier one's graph.  The update lands
on the observer-written qparams as in ``make_train_step``.

The replicated leaves' gradients are summed over 'stage', so every stage
takes the same step; the embed's quantizers come back from stage 0 and the
head's from the last stage.  Over 'data' each replica's observers see only
its rows and the LSQ gradient scale counts the local microbatch (no
``_dist.splitting``), the gradients are summed and the loss is divided by
MB · D, and after the backward every floating leaf of the quantizers
(qparams, observer ranges) is averaged over 'data'.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from .. import _dist
from .._device import device_of, resolve_device
from ..models.layers import FakeQuantize, fake_quant_hook, refresh_host_state
from ..models.zoo import QuantTransformerLM
from .train import _BUCKET, _CapturedStep, _flat, _quantizers, _traced, _unflat

__all__ = ["pipeline_mesh", "stack_pipeline_variables", "unstack_pipeline_variables",
           "pipeline_sharding", "create_pipeline_state", "make_pipeline_train_step",
           "PipelineStage", "gather_pipeline_model"]


def pipeline_mesh(stage: int, data: int = 1,
                  devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A (data, stage) mesh over ``devices`` (process ranks, default every
    process of the default group) for pipeline(+data)-parallel training.
    Every process of the default group must call it."""
    if not dist.is_initialized():
        raise RuntimeError("pipeline_mesh needs torch.distributed initialized: "
                           "call initialize_distributed() first")
    devices = list(range(dist.get_world_size()) if devices is None else devices)
    if data * stage > len(devices):
        raise ValueError(f"mesh {data}x{stage} needs {data * stage} devices, "
                         f"have {len(devices)}")
    ranks = torch.tensor(devices[:data * stage], dtype=torch.int64).reshape(data, stage)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "stage"))


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def stack_pipeline_variables(tree: Any, depth: int, stages: int) -> Any:
    """Restack a collection tree's ``block{i}`` scopes (numpy leaves, as
    ``interop.qat_variables`` writes them) into one ``blocks`` entry with
    leading (S, depth/S) axes; non-block keys pass through.  Inverse:
    :func:`unstack_pipeline_variables`."""
    if not isinstance(tree, dict) or "block0" not in tree:
        return tree
    if depth % stages:
        raise ValueError(f"depth {depth} not divisible by {stages} stages")
    per = depth // stages
    blocks = [tree[f"block{i}"] for i in range(depth)]
    stacked = _map(lambda *xs: np.stack([_np(x) for x in xs]).reshape(
        (stages, per) + _np(xs[0]).shape), *blocks)
    out = {k: v for k, v in tree.items() if not k.startswith("block")}
    out["blocks"] = stacked
    return out


def unstack_pipeline_variables(tree: Any, depth: int) -> Any:
    """``blocks`` (S, L, ...) back to ``block{i}`` scopes (feed the result to
    ``interop.load_qat_variables`` or ``serve.convert``)."""
    if not isinstance(tree, dict) or "blocks" not in tree:
        return tree
    flat = _map(lambda a: _np(a).reshape((-1,) + _np(a).shape[2:]), tree["blocks"])
    out = {k: v for k, v in tree.items() if k != "blocks"}
    for i in range(depth):
        out[f"block{i}"] = _map(lambda a: a[i], flat)
    return out


def pipeline_sharding(mesh: DeviceMesh, tree: Any) -> Dict[str, tuple]:
    """The placements of a stacked tree (:func:`stack_pipeline_variables`),
    in the form ``parallel.placement`` takes (one ``Shard``/``Replicate`` per
    mesh axis), keyed by the leaf's '/'-joined path: ``Shard(0)`` over
    'stage' for every leaf under ``blocks`` with a leading axis (stage s
    holds blocks s·L … (s + 1)·L − 1), replicated otherwise (the embed,
    head, norms, ``pos_emb``)."""
    names = tuple(mesh.mesh_dim_names)
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        split = "blocks" in path and getattr(_np(node), "ndim", 0) >= 1
        out["/".join(path)] = tuple(Shard(0) if split and n == "stage" else Replicate()
                                    for n in names)

    walk(tree, ())
    return out


def _axis(mesh: DeviceMesh, name: str):
    """(size, this process's index, group) of mesh axis ``name``."""
    i = mesh.mesh_dim_names.index(name)
    return mesh.size(i), mesh.get_local_rank(name), mesh.get_group(i)


def _check_blocks(model) -> None:
    if getattr(model, "attn_window", None) is not None:
        raise ValueError("the pipeline's blocks run causal attention without a window "
                         "(jaxlsq builds them without one); got attn_window="
                         f"{model.attn_window}")
    if getattr(model, "train_attn_impl", "xla") != "xla":
        raise ValueError("the pipeline's blocks run train_attn_impl='xla' (jaxlsq builds "
                         f"them so); got {model.train_attn_impl!r}")


class PipelineStage(nn.Module):
    """One stage of a pipelined ``QuantTransformerLM``: the embed (and a
    learned ``pos_emb``), blocks ``stage·L … (stage + 1)·L − 1`` under their
    own names (``block{i}``), ``ln_f`` and ``lm_head``.  The embed, head and
    norm are replicas on every stage; stage 0 runs the embed and the last
    stage the head.  ``stage(x)`` is the stage's part of the eval forward:
    tokens in on stage 0, logits out of the last."""

    def __init__(self, model: QuantTransformerLM, stage: int, stages: int, device):
        super().__init__()
        if model.depth % stages:
            raise ValueError(f"depth {model.depth} not divisible by stage={stages}")
        if not model.qat:
            raise ValueError("a pipeline stage trains a QAT-mode QuantTransformerLM")
        _check_blocks(model)
        self.config = dict(vocab=model.vocab, dim=model.dim, depth=model.depth,
                           num_heads=model.num_heads, qconfig=model.qconfig,
                           max_len=model.max_len, num_kv_heads=model.num_kv_heads,
                           pos_embedding=model.pos_embedding,
                           moe_experts=model.moe_experts, moe_top_k=model.moe_top_k,
                           moe_capacity_factor=model.moe_capacity_factor)
        self.stage, self.stages = stage, stages
        per = model.depth // stages
        self.block_ids = tuple(range(stage * per, (stage + 1) * per))

        def own(mod):
            return copy.deepcopy(mod).to(device)

        self.tok_emb = own(model.tok_emb)
        if model.pos_embedding == "learned":
            self.pos_emb = nn.Parameter(model.pos_emb.detach().to(device, copy=True))
        for i in self.block_ids:
            self.add_module(f"block{i}", own(getattr(model, f"block{i}")))
        self.ln_f = own(model.ln_f)
        self.lm_head = own(model.lm_head)

    @property
    def is_first(self) -> bool:
        return self.stage == 0

    @property
    def is_last(self) -> bool:
        return self.stage == self.stages - 1

    def blocks(self):
        return [getattr(self, f"block{i}") for i in self.block_ids]

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.tok_emb(tokens)
        if self.config["pos_embedding"] == "learned":
            t = tokens.shape[1]
            if t > self.config["max_len"]:
                raise ValueError(f"sequence length {t} exceeds max_len "
                                 f"{self.config['max_len']}")
            x = x + self.pos_emb[None, :t]
        return x

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks():
            x = block(x)
        return x

    def head(self, y: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.ln_f(y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.is_first:
            x = self.embed(x)
        x = self.run_blocks(x)
        return self.head(x) if self.is_last else x


def create_pipeline_state(model: QuantTransformerLM,
                          tx: Callable[[list], torch.optim.Optimizer],
                          mesh: DeviceMesh, *, device=None):
    """This process's :class:`PipelineStage` of the QAT-mode ``model`` (its
    state as it stands: build the model from a seed, or load a carried
    tree, first) and ``tx(stage parameters)``, its optimizer: jaxlsq's
    stage-sharded ``QATTrainState``.  The stage owns copies on ``device``
    (the card unless another is named), so ``model`` may be dropped: a
    process then holds 1/S of the blocks.  A model with ``attn_window`` or
    ``train_attn_impl='flash'`` raises ``ValueError`` (jaxlsq's pipeline
    blocks run neither)."""
    stages, stage, _ = _axis(mesh, "stage")
    st = PipelineStage(model, stage, stages, resolve_device(device))
    return st, tx(list(st.parameters()))


def gather_pipeline_model(stage: PipelineStage, mesh: DeviceMesh,
                          device=None) -> QuantTransformerLM:
    """The stages' blocks gathered into one plain QAT-mode
    ``QuantTransformerLM`` on every process of the stage group (jaxlsq's
    ``device_get`` of the stage-sharded state, unstacked): ``convert``,
    ``interop``, ``make_generate`` and ``utils.checkpoint`` take it.  A
    collective over 'stage' (trees pickled through the process group)."""
    from ..interop import load_qat_variables, qat_variables

    stages, _, group = _axis(mesh, "stage")
    tree = qat_variables(stage)
    if stages > 1:
        trees = [None] * stages
        dist.all_gather_object(trees, tree, group=group)
        for other in trees:
            for col, node in other.items():
                tree[col].update({k: v for k, v in node.items() if k.startswith("block")})
    lm = QuantTransformerLM(**stage.config, device=device or device_of(stage))
    load_qat_variables(lm, tree)
    return lm


class _Bind(torch.autograd.Function):
    """``value`` forward; its gradient goes to ``param`` (a qparam snapshot
    that trains the parameter it was taken from)."""

    @staticmethod
    def forward(ctx, value, param):
        return value.view_as(value)

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def _bound(value: torch.Tensor, param: torch.Tensor, gate) -> torch.Tensor:
    """``value``, trained into ``param`` where ``gate`` (a host bool or a
    device bool) holds."""
    if gate is False:
        return value
    bound = _Bind.apply(value, param)
    return bound if gate is True else torch.where(gate, bound, value)


class MicrobatchTape:
    """The quantizers' side of a pipeline step, the hook of every
    :class:`FakeQuantize` forward while the step runs: the forward of
    microbatch ``mb`` advances the state and keeps it as usual, then
    fake-quantizes with a snapshot of the qparams it used, recorded on the
    tape (while no observer has written them in this step, the parameters
    themselves).  A snapshot trains the parameter only while no observer
    has written it in this step: jaxlsq's pipeline carries an observer's
    write, a stop-gradient value, to the later microbatches, so their
    scale gradients wait for the next step (``pipeline.py:29-35``); a host
    bool in the eager regime, a device bool in the traced one.  So a later
    microbatch's write in place never reaches an earlier microbatch's
    graph.  Under :meth:`replay` a forward writes nothing and runs the
    recorded fake quantization again (the recompute of ``remat``)."""

    def __init__(self):
        self.mb = 0
        self.replaying = False
        self._clean = {}   # quantizer -> no observer write yet in this step
        self._calls = {}   # (microbatch, quantizer) -> recorded calls, in order

    @contextlib.contextmanager
    def replay(self, mb: int):
        self.mb, self.replaying = mb, True
        try:
            yield
        finally:
            self.replaying = False

    def __call__(self, fq: FakeQuantize, x: torch.Tensor) -> torch.Tensor:
        if self.replaying:
            return self._apply(fq, x, self._calls[(self.mb, fq)].pop(0))
        clean = self._clean.get(fq, True)
        observed = fq.cfg.observer is not None
        if fq.traced:
            st, modes = fq.cfg.advance_traced(fq.quant_state(traced=True), x, fq.training)
            if observed:  # the observer wrote where it was on
                clean = ~st.observer_enabled if clean is True else clean & ~st.observer_enabled
        else:
            st, modes = fq.cfg.advance(fq.quant_state(), x, fq.training)
            clean = clean and not (observed and st.observer_enabled)
        if fq.persist_state:
            fq.load_quant_state(st)
        gate = self._clean[fq] = clean
        # untouched in this step, eagerly: the parameters themselves (no
        # observer writes them later in the step: the window only closes)
        snap = (None, None) if gate is True else (st.scale.detach().clone(),
                                                  st.shift.detach().clone())
        call = (*snap, gate, fq.traced, modes)
        self._calls.setdefault((self.mb, fq), []).append(call)
        return self._apply(fq, x, call)

    @staticmethod
    def _apply(fq: FakeQuantize, x: torch.Tensor, call) -> torch.Tensor:
        scale, shift, gate, traced, modes = call
        if scale is None:
            scale, shift = fq.scale, fq.shift
        else:
            scale, shift = _bound(scale, fq.scale, gate), _bound(shift, fq.shift, gate)
        return fq.cfg.quantize(x, scale, shift, modes, traced)


def _lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The shifted cross entropy of one microbatch (jaxlsq's ``_lm_loss``)."""
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v), labels[:, 1:].reshape(-1))


def _sum_grads(params, group) -> None:
    """Every gradient of ``params`` summed over ``group`` in flat buckets."""
    for i in range(0, len(params), _BUCKET):
        chunk = params[i:i + _BUCKET]
        flat = torch.cat([p.grad.reshape(-1) for p in chunk])
        _dist.all_reduce(flat, "sum", group)
        _unflat([p.grad for p in chunk], flat)


def _float_state(fq: FakeQuantize):
    return [fq.scale, fq.shift] + [t for t in fq.obs_buffers().values()
                                   if t.is_floating_point()]


@torch.no_grad()
def _mean_floats(fqs, group, size: int) -> None:
    """The quantizers' floating leaves (qparams and observer ranges)
    averaged over ``group`` in place: jaxlsq's pmean over 'data'."""
    ts = [t for m in fqs for t in _float_state(m)]
    flat = torch.cat([t.reshape(-1) for t in ts])
    _dist.all_reduce(flat, "sum", group).div_(float(size))
    torch._foreach_copy_(ts, [c.view_as(t) for c, t in zip(flat.split(
        [t.numel() for t in ts]), ts)])


@torch.no_grad()
def _from_stage(fqs, src: int, group) -> None:
    """Every leaf of the quantizers ``fqs`` set to stage ``src``'s (jaxlsq's
    ``_from_stage``): one broadcast of the floats, one of the counters and
    flags (as int32)."""
    floats = [t for m in fqs for t in _float_state(m)]
    ints = [t for m in fqs for t in m.buffers() if not t.is_floating_point()]
    for ts, dt in ((floats, torch.float32), (ints, torch.int32)):
        if not ts:
            continue
        flat = _dist.broadcast(torch.cat([t.reshape(-1).to(dt) for t in ts]), src, group)
        for c, t in zip(flat.split([t.numel() for t in ts]), ts):
            t.copy_(c.view_as(t).to(t.dtype))
    for m in fqs:
        m.invalidate_host_state()


def make_pipeline_train_step(stage: PipelineStage, optimizer: torch.optim.Optimizer,
                             mesh: DeviceMesh, *, num_microbatches: int,
                             loss_fn: Callable = _lm_loss, donate: bool = True,
                             remat: bool = False, jit: bool = True):
    """``step(batch) -> {"loss": loss}`` for this process's ``stage``
    (:func:`create_pipeline_state`), updating it and ``optimizer`` in place.
    ``batch`` = {'input': tokens, 'label': labels}, this data replica's
    rows (``shard_batch(batch, mesh)``; every stage of a replica passes the
    same), split into ``num_microbatches`` microbatches.  ``loss_fn``
    takes (logits, labels) of ONE microbatch, as jaxlsq's.  The loss
    returned (a device scalar) is the global one on every process.

    ``remat=True`` keeps only each stage's input a microbatch and reruns
    the blocks in the backward; the rerun writes nothing and fake-quantizes
    with the first pass's qparams, so the step is the same bit for bit.
    ``jit`` is ``make_train_step``'s: the traced regime, on a card one CUDA
    graph (which needs NCCL: a gloo group raises; across stages it is
    refused, ``NotImplementedError``, until it has run on several cards).  ``donate`` is jaxlsq's
    argument and changes nothing here.  MoE blocks raise
    ``NotImplementedError``, as in jaxlsq.  A step issues 2·(S − 1)·MB
    sends and as many receives a data replica (``_dist.COUNTS``)."""
    del donate
    if stage.config.get("moe_experts"):
        raise NotImplementedError(
            "pipeline over MoE blocks is not wired (expert axis and stage axis would "
            "need a joint schedule); use moe_sharding for EP")
    stages, sid, sgroup = _axis(mesh, "stage")
    data, _, dgroup = _axis(mesh, "data")
    depth = stage.config["depth"]
    if depth % stages:
        raise ValueError(f"depth {depth} not divisible by stage={stages}")
    mb_count = int(num_microbatches)
    if mb_count < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {mb_count}")
    if stage.stages != stages or stage.stage != sid:
        raise ValueError(f"the stage module is stage {stage.stage} of {stage.stages}, "
                         f"the mesh gives this process stage {sid} of {stages}")
    device = device_of(stage)
    if jit and device.type == "cuda" and dist.get_backend() != "nccl":
        raise ValueError("make_pipeline_train_step(jit=True) on a card captures the "
                         "step's sends and collectives in a CUDA graph, which the "
                         f"{dist.get_backend()!r} backend cannot; use NCCL or jit=False")
    if jit and device.type == "cuda" and stages > 1:
        raise NotImplementedError(
            "make_pipeline_train_step(jit=True) across stages on cards (a CUDA graph "
            "holding the NCCL sends and receives) has not been verified; use jit=False")
    params = [p for group in optimizer.param_groups for p in group["params"]]
    in_opt = {id(p) for p in params}
    block_params = {id(p) for b in stage.blocks() for p in b.parameters()}
    shared = [p for p in params if id(p) not in block_params]
    fqs = _quantizers(stage)
    qps = [p for m in fqs for p in (m.scale, m.shift) if id(p) in in_opt]
    emb_fqs, head_fqs = _quantizers(stage.tok_emb), _quantizers(stage.lm_head)
    dim = stage.config["dim"]

    def body(batch: Dict) -> torch.Tensor:
        stage.train()
        tokens, labels = batch["input"], batch["label"]
        rows, t = tokens.shape
        if rows % mb_count:
            raise ValueError(f"local batch {rows} not divisible by {mb_count} microbatches")
        bm = rows // mb_count
        old = _flat(qps)
        optimizer.zero_grad(set_to_none=True)
        tape = MicrobatchTape()
        ins, outs, losses = [], [], []
        with fake_quant_hook(tape):
            for j in range(mb_count):
                tape.mb = j
                if stage.is_first:
                    x = stage.embed(tokens[j * bm:(j + 1) * bm])
                else:
                    x = _dist.recv((bm, t, dim), torch.float32, device, sid - 1, sgroup)
                    x.requires_grad_()
                with torch.no_grad() if remat else contextlib.nullcontext():
                    y = stage.run_blocks(x)
                if stage.is_last:
                    if remat:
                        y = y.detach().requires_grad_()
                    losses.append(loss_fn(stage.head(y), labels[j * bm:(j + 1) * bm]))
                else:
                    _dist.send(y, sid + 1, sgroup)
                ins.append(x)
                outs.append(y)
            for j in range(mb_count):
                grad = None
                if stage.is_last:
                    losses[j].backward()
                    if remat:
                        grad = outs[j].grad
                else:
                    grad = _dist.recv(outs[j].shape, torch.float32, device, sid + 1, sgroup)
                if remat:
                    with tape.replay(j):
                        y = stage.run_blocks(ins[j])
                    torch.autograd.backward(y, grad)
                elif not stage.is_last:
                    torch.autograd.backward(outs[j], grad)
                if not stage.is_first:
                    _dist.send(ins[j].grad, sid - 1, sgroup)
                ins[j] = outs[j] = None
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if data > 1:
            _sum_grads(params, dgroup)
        if stages > 1:
            _sum_grads(shared, sgroup)
        for p in params:
            p.grad.div_(mb_count * data)
        if data > 1:
            _mean_floats(fqs, dgroup, data)
        if stages > 1:
            _from_stage(emb_fqs, 0, sgroup)
            _from_stage(head_fqs, stages - 1, sgroup)
        new = _flat(qps)
        _unflat(qps, old)
        optimizer.step()
        if qps:  # new + update, the update taken at old
            stepped = _flat(qps)
            _unflat(qps, torch.where(new == old, stepped, new + (stepped - old)))
        if stage.is_last:
            loss = torch.stack([x.detach() for x in losses]).mean()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=device)
        if data > 1:
            loss = _dist.all_reduce(loss / float(data), "sum", dgroup)
        if stages > 1:
            loss = _dist.all_reduce(loss, "sum", sgroup)
        return loss

    if not jit:
        def eager_step(batch: Dict) -> Dict[str, torch.Tensor]:
            refresh_host_state(fqs)
            return {"loss": body(batch)}
        return eager_step

    if device.type == "cuda":
        return _CapturedStep(body, fqs, device, optimizer)

    def traced_step(batch: Dict) -> Dict[str, torch.Tensor]:
        with _traced(fqs):
            return {"loss": body(batch)}
    return traced_step
