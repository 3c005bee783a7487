"""Quantized Mixture-of-Experts (port of ``jaxlsq/models/moe.py``): top-k
routed expert MLPs with LSQ quantizers.

* :func:`route` is GShard's choice-major capacity routing: the top-k gates
  of each token (ties to the lower expert index, as ``jax.lax.top_k``: a
  stable descending sort), renormalized over its picks; queue slots
  assigned choice-major by a cumulative count per expert; a pick at slot
  >= C dropped.  It returns ``dispatch`` and ``combine``, (N, E, C) each,
  with no host read, so a CUDA graph captures it.
* :func:`load_balance_loss` is the Switch Transformer's auxiliary loss.
* :class:`QuantMoE` routes the tokens with a float router (``router``, an
  ``nn.Linear`` without bias: the JAX package's ``router.kernel`` is its
  weight transposed), dispatches them by einsum into (E, C, d) expert
  batches, runs the two stacked expert layers (``experts_up``, gelu in its
  tanh form, ``experts_down``) and combines by einsum; every einsum is f32.
  In QAT mode it records ``aux_loss_weight * load_balance_loss`` with
  :func:`sow_loss`, which ``make_train_step`` adds to the objective.
* ``_ExpertDense`` is the stacked per-expert dense layer, (E, C, K) ->
  (E, C, N) with an (E, K, N) kernel.  QAT mode: an activation quantizer
  over the last axis and the weight quantized per expert (per-channel axis
  0).  Serve mode holds the pack (per-expert qparams, int4 along k_axis 1
  when the trained range fits the signed int4 carrier): ``'none'`` and
  ``'static'`` run one ``wo_matmul`` per expert on the card (the JAX
  package's ``serve_impl='pallas'`` scan) and the plain f32 einsum over the
  dequantized stack on the CPU (its ``serve_precision='highest'`` path);
  ``'static_int8'`` runs the batched int8 x int8 product over the experts
  (``serve.matmul.static_int8_bmm``), an int4 stack unpacked to int8
  first; ``'dynamic'`` raises ``ValueError``.

Capacity drops couple the tokens routed together; with ``capacity_factor
>= num_experts / top_k``, C = N and routing is exactly per token (the
serving engines warn otherwise).

Under a multi-device step (``_dist.current()``, the rows split over 'data')
the routing is the global batch's: C from the global token count, the queue
slots in the global choice-major order (each process's offsets from every
process's pick counts), and the dispatched (E, C, d) batch summed over the
processes, so the experts see the global batch and the drops are the
one-device step's; the load-balance loss takes the global shares.  With
expert parallelism (``parallel.moe.moe_sharding``, the stacks over an
'expert' axis) a process runs its E/ep experts on their global slots (the
experts' quantizers under that split) and all-gathers their outputs before
the combine; no stack is gathered.  Every 'data' process runs its experts
on all the global slots, so replicas of an expert over 'data' repeat that
work; experts placed over 'data' itself (``moe_sharding(axis='data')``)
have none.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import _dist
from .._device import resolve_device
from ..serve.convert import serving_bits
from ..serve.matmul import static_int8_bmm, wo_matmul
from ..serve.pack import PackedWeight, dequantize_weight, unpack_int4
from .layers import (_PackedBuffers, _fake_quantizer, _serve_act_qparams, sow_loss,
                     static_act_quant)
from .qconfig import QConfig

__all__ = ["QuantMoE", "load_balance_loss", "route"]


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row (and no
    host read, as ``F.one_hot``'s range check would make)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _queue_offsets(oh: torch.Tensor, part) -> torch.Tensor:
    """(K, E) int32: where this process's picks start in each expert's
    global choice-major queue, from every process's (K, E) pick counts
    (gathered in rank order; the global rows are rank-major): the later
    choices of the lower ranks are not in front, the earlier choices of all
    ranks and this choice of the lower ranks are."""
    local = oh.sum(dim=0)                                           # (K, E)
    counts = _dist.all_gather(local[None], part.group, part.size, 0)  # (W, K, E)
    total = counts.sum(dim=0)
    lower = counts[:part.rank].sum(dim=0)
    earlier = torch.cumsum(total - local, dim=0) - (total - local)
    return (earlier + lower).to(torch.int32)


def route(gates: torch.Tensor, top_k: int, capacity: int, part=None):
    """(N, E) router probabilities -> ``(dispatch, combine)``, (N, E, C) each:
    the top-k gates renormalized to a convex mixture over the picks, queue
    slots assigned choice-major, picks at slot >= C dropped (combine 0);
    ``dispatch`` is the {0, 1} support of ``combine``.  With ``part`` (a
    ``_dist.Part`` over dim 0) the rows are this process's of a global
    batch, and the slots are those of the global queue."""
    n, e = gates.shape
    k, c = top_k, capacity
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    gate_k, idx_k = vals[:, :k], idx[:, :k]
    total = gate_k[:, 0]
    for j in range(1, k):
        total = total + gate_k[:, j]
    total = torch.maximum(total, torch.full_like(total, torch.finfo(gates.dtype).tiny))
    gate_k = gate_k / total[:, None]
    oh = _one_hot(idx_k, e, torch.int32)                        # (N, K, E)
    pos = torch.cumsum(oh.transpose(0, 1).reshape(k * n, e), dim=0) - 1
    pos = pos.reshape(k, n, e).transpose(0, 1)
    if part is not None:
        pos = pos + _queue_offsets(oh, part)[None]
    pos = (pos * oh).sum(-1)                                    # (N, K) queue slot
    keep = (pos < c).to(gates.dtype)
    slot = _one_hot(pos, c, gates.dtype)                        # (N, K, C)
    ohf = oh.to(gates.dtype)
    combine = torch.zeros((n, e, c), dtype=gates.dtype, device=gates.device)
    for j in range(k):  # one nonzero term an (n, e, c): the sum is exact
        combine = combine + ((gate_k[:, j] * keep[:, j])[:, None, None]
                             * ohf[:, j, :, None] * slot[:, j, None, :])
    dispatch = (combine > 0).to(gates.dtype)
    return dispatch, combine


def load_balance_loss(gates: torch.Tensor, top1: torch.Tensor) -> torch.Tensor:
    """``E * sum_e f_e P_e``: f_e the share of tokens whose top-1 expert is
    e, P_e the mean router probability of e (1.0 when balanced).  Under a
    split of the rows (``_dist.current()``) both are the global batch's
    (P_e with a backward)."""
    e = gates.shape[-1]
    f = torch.mean(_one_hot(top1, e, gates.dtype), dim=0)
    p = torch.mean(gates, dim=0)
    split = _dist.current()
    if split is not None:
        f = _dist.reduce_sum(f, split) / float(split.factor)
        p = _dist.mean_grad(p, split)
    return e * torch.sum(f * p)


def expert_carrier(packed: PackedWeight) -> torch.Tensor:
    """The int8 view of a stacked (E, K, N) pack: an int4 stack unpacks its
    k_axis 1 (an odd K's pad row sliced away)."""
    if packed.bits != 4:
        return packed.data
    q = unpack_int4(packed.data, k_axis=1)
    return q[:, :packed.orig_shape[1]]


class _ExpertDense(nn.Module):
    """Stacked per-expert dense: x (E, C, K) -> (E, C, N), kernel (E, K, N)
    with per-expert weight qparams (per-channel axis 0)."""

    def __init__(self, num_experts: int, in_features: int, features: int,
                 qconfig: QConfig, *, path: Sequence[str] = (), device=None):
        super().__init__()
        qc = qconfig.resolve(tuple(path))
        self.kshape = (num_experts, in_features, features)
        self.lo = None  # the first local expert under expert parallelism
        self.qat = qc.mode != "serve"
        device = resolve_device(device)
        if self.qat:
            self.act_fq = _fake_quantizer(qc.activation_for_axis(-1), in_features, device)
            self.kernel = nn.Parameter(torch.zeros(self.kshape, device=device))
            self.weight_fq = _fake_quantizer(qc.weight_for_axis(0), num_experts, device)
            self.bias = nn.Parameter(torch.zeros(features, device=device))
            return
        wspec = qc.required_weight_for_axis(0).spec
        self.kernel = _PackedBuffers(self.kshape, serving_bits(wspec), 0, 1,
                                     num_experts if wspec.per_channel else 1, device)
        _serve_act_qparams(self, qc, in_features, device)
        self.bias = nn.Parameter(torch.zeros(features, device=device), requires_grad=False)

    def set_local_experts(self, part) -> None:
        """Hold experts [rank E / size, (rank + 1) E / size) of ``part``'s
        axis (``parallel.apply_sharding`` has chunked the stacks)."""
        if self.lo is not None:
            return
        e = self.kshape[0] // part.size
        self.lo = part.rank * e
        self.kshape = (e,) + self.kshape[1:]
        if not self.qat:
            self.kernel.orig_shape = self.kshape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.qat:
            if self.act_fq is not None:
                x = self.act_fq(x)
            w = self.kernel if self.weight_fq is None else self.weight_fq(self.kernel)
            y = torch.einsum("eck,ekn->ecn", x, w)
        else:
            y = self._serve(x)
        return (y + self.bias).to(x.dtype)

    def _serve(self, x: torch.Tensor) -> torch.Tensor:
        packed = self.kernel.packed()
        if self.aspec is not None:
            if self.act_mode == "dynamic":
                raise ValueError(
                    "QuantMoE serving supports act_mode 'none', 'static' or "
                    "'static_int8'; got 'dynamic' (per-microbatch dynamic ranges "
                    "interact with routing; use static qparams)")
            if self.act_mode == "static_int8":
                return static_int8_bmm(x, expert_carrier(packed), *self._expert_qparams(packed),
                                       self.act_scale, self.act_zp,
                                       self.aspec.quant_min, self.aspec.quant_max)
            if self.act_mode == "static":
                x = static_act_quant(x, self.act_scale, self.act_zp, self.aspec)
        scale, zp = self._expert_qparams(packed)
        if x.device.type == "cpu":
            local = PackedWeight(packed.data, scale, zp, bits=packed.bits,
                                 axis=packed.axis, k_axis=packed.k_axis,
                                 orig_shape=packed.orig_shape)
            return torch.einsum("eck,ekn->ecn", x.to(torch.float32),
                                dequantize_weight(local, torch.float32))
        # one weight-only matmul a expert (the wo8 / wo4 kernels)
        e, k, n = self.kshape
        per_expert = scale.numel() > 1
        outs = []
        for i in range(e):
            j = i if per_expert else 0
            p = PackedWeight(packed.data[i], scale[j:j + 1], zp[j:j + 1],
                             bits=packed.bits, axis=1, k_axis=0, orig_shape=(k, n))
            outs.append(wo_matmul(x[i], p))
        return torch.stack(outs)

    def _expert_qparams(self, packed: PackedWeight):
        """The local experts' per-expert scale and zero point (the stacks
        are chunked under expert parallelism; these stay whole, as jaxlsq's
        ``moe_sharding`` leaves them)."""
        if self.lo is None or packed.scale.numel() == 1:
            return packed.scale, packed.zero_point
        e = self.kshape[0]
        return packed.scale[self.lo:self.lo + e], packed.zero_point[self.lo:self.lo + e]


class QuantMoE(nn.Module):
    """Top-k routed MoE MLP: x (..., d) -> (..., d).  Every expert is a
    2-layer gelu MLP ``hidden`` wide with QuantDense's quantizers (per-expert
    weight scales); the router stays float; dropped tokens contribute zero
    (callers wrap it in a residual)."""

    def __init__(self, dim: int, hidden: int, num_experts: int, qconfig: QConfig, *,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 aux_loss_weight: float = 0.01, path: Sequence[str] = (), device=None):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} must be in [1, {num_experts}]")
        device = resolve_device(device)
        path = tuple(path)
        self.dim, self.hidden, self.num_experts = dim, hidden, num_experts
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.qconfig = qconfig
        self.qat = qconfig.mode != "serve"
        self.router = nn.Linear(dim, num_experts, bias=False, device=device)
        self.experts_up = _ExpertDense(num_experts, dim, hidden, qconfig,
                                       path=path + ("experts_up",), device=device)
        self.experts_down = _ExpertDense(num_experts, hidden, dim, qconfig,
                                         path=path + ("experts_down",), device=device)
        if not self.qat:
            self.router.requires_grad_(False)
        # expert parallelism (parallel.moe.moe_sharding): the _dist.Part of
        # the 'expert' axis whose rank-th E/size experts this process holds
        self.ep = None

    def capacity(self, tokens: int) -> int:
        """C = min(max(1, ceil(K N cf / E)), N)."""
        c = max(1, math.ceil(self.top_k * tokens * self.capacity_factor / self.num_experts))
        return min(c, tokens)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *lead, d = x.shape
        n = math.prod(lead)
        xt = x.reshape(n, d)
        gates = torch.softmax(self.router(xt.to(torch.float32)), dim=-1)
        split = _dist.current()
        part = None
        if split is not None:
            # a process's rows of a global batch: the global capacity and
            # queue, and the dispatched batch summed into the global one
            if len(split.parts) != 1 or split.parts[0].dim != 0:
                raise ValueError("QuantMoE under a mesh takes the rows split over "
                                 "one axis (dim 0); sequence parallelism is not "
                                 "supported")
            part = split.parts[0]
        dispatch, combine = route(gates, self.top_k,
                                  self.capacity(n * (split.factor if split else 1)),
                                  part)
        xe = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), xt)
        if part is not None:
            xe = _dist.all_reduce_grad(xe, part.group)
        inner = None
        if self.ep is not None:  # this process's experts; their outputs gathered
            lo = self.ep.rank * xe.shape[0] // self.ep.size
            xe = xe[lo:lo + xe.shape[0] // self.ep.size]
            inner = _dist.Split((self.ep,), weights=True)
        with _dist.splitting(inner):
            h = F.gelu(self.experts_up(xe), approximate="tanh")
            ye = self.experts_down(h)
        if self.ep is not None:
            ye = _dist.all_gather_grad(ye, self.ep.group, self.ep.size, 0)
        y = torch.einsum("nec,ecd->nd", combine.to(x.dtype), ye.to(x.dtype))
        if self.qat:
            sow_loss(self.aux_loss_weight * load_balance_loss(gates, gates.argmax(-1)))
        return y.reshape(*lead, d)
