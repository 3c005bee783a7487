"""QAT optimizer partition: the weights and the quantizers' step sizes (port
of ``jaxlsq/parallel/optim.py``).

LSQ's ``1/sqrt(numel * quant_max)`` gradient scale assumes an SGD-class
optimizer, whose update follows the gradient's size; Adam normalises every
update to about lr, and AdamW also decays scale and shift toward zero.
:func:`qat_optimizer` gives every ``FakeQuantize`` ``scale``/``shift`` its
own optimizer (by default SGD with momentum 0.9 and no weight decay, after a
global-norm gradient clip) and every other parameter, BatchNorm's included,
the user's.  After the step each scale is held at or above the f32 eps
(:func:`project_scale_floor`).

In PyTorch's idiom the result is one ``torch.optim.Optimizer`` over the
model's parameters: its ``param_groups`` are the two inner optimizers' own
group dicts (the weights' first), so an lr written into a group reaches the
optimizer that owns it, and ``make_train_step(jit=True)`` keeps each group's
lr live on the card.  Under a captured step both inner optimizers must read
their lr from the card: ``Adam``/``AdamW`` with ``capturable=True``, ``SGD``
with ``fused=True`` (the default quantizer SGD is fused when the
parameters are on a CUDA device).  The clip and the projection are device
ops with no host read.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from ..models.layers import FakeQuantize

__all__ = ["QATOptimizer", "qat_optimizer", "project_scale_floor"]

F32_EPS = 1.1920929e-07  # the floor the fake-quant kernels clamp a scale to

Factory = Callable[[List[nn.Parameter]], torch.optim.Optimizer]


@torch.no_grad()
def project_scale_floor(scales: Sequence[torch.Tensor], eps: float = F32_EPS) -> None:
    """Every tensor of ``scales`` to ``max(scale, eps)`` in place: the update
    ``u`` of a scale ``p`` becomes ``max(p + u, eps) - p`` when applied to
    the ``p`` it was computed from.  A scale driven negative would invert its
    gradient's effect (the forward uses ``max(eps, |scale|)``); torch.ao's
    ``_LearnableFakeQuantize`` clamps after each step for the same reason."""
    for s in scales:
        s.clamp_(min=eps)


class _States:
    """The inner optimizers' ``state`` maps read as one (a parameter in
    neither has an empty state)."""

    def __init__(self, opts):
        self.opts = opts

    def __getitem__(self, p):
        for o in self.opts:
            if p in o.state:
                return o.state[p]
        return {}

    def __contains__(self, p):
        return any(p in o.state for o in self.opts)

    def items(self):
        for o in self.opts:
            yield from o.state.items()


class QATOptimizer(torch.optim.Optimizer):
    """``weights`` over the model's weights and ``qparams`` over its
    quantizers' scale/shift (None for a model with no quantizer).  ``step``
    clips the qparams' gradients to global norm ``grad_clip`` (optax's
    ``clip_by_global_norm``: ``g`` while the norm is below it, else ``g /
    norm * grad_clip``), steps both optimizers and, with ``scales``, holds
    each at or above the f32 eps."""

    def __init__(self, weights: Optional[torch.optim.Optimizer],
                 qparams: Optional[torch.optim.Optimizer], *,
                 grad_clip: Optional[float] = 1.0,
                 scales: Sequence[torch.Tensor] = ()):
        self.inner = [o for o in (weights, qparams) if o is not None]
        if not self.inner:
            raise ValueError("qat_optimizer: the model has no parameter")
        self.weights, self.qparams = weights, qparams
        self.grad_clip = grad_clip
        self.scales = list(scales)
        super().__init__([p for o in self.inner for g in o.param_groups
                          for p in g["params"]], {})
        # the inner optimizers' own group dicts: a write to one reaches its owner
        self.param_groups = [g for o in self.inner for g in o.param_groups]
        self.state = _States(self.inner)

    def _qparam_grads(self) -> List[torch.Tensor]:
        if self.qparams is None:
            return []
        return [p.grad for g in self.qparams.param_groups for p in g["params"]
                if p.grad is not None]

    @torch.no_grad()
    def _clip_qparam_grads(self) -> None:
        grads = self._qparam_grads()
        if self.grad_clip is None or not grads:
            return
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        below = norm < self.grad_clip
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(below, one, norm))
        torch._foreach_mul_(grads, torch.where(below, one, one * self.grad_clip))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._clip_qparam_grads()
        for o in self.inner:
            o.step()
        if self.scales:
            project_scale_floor(self.scales)
        return loss

    def zero_grad(self, set_to_none: bool = True) -> None:
        for o in self.inner:
            o.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> Dict:
        return {"weights": None if self.weights is None else self.weights.state_dict(),
                "qparams": None if self.qparams is None else self.qparams.state_dict()}

    def load_state_dict(self, state_dict: Dict) -> None:
        for o, key in ((self.weights, "weights"), (self.qparams, "qparams")):
            if o is not None:
                o.load_state_dict(state_dict[key])


def qat_optimizer(model: nn.Module, weights: Factory, qparams: Optional[Factory] = None,
                  *, qparam_lr: float = 0.01, qparam_momentum: float = 0.9,
                  qparam_grad_clip: Optional[float] = 1.0,
                  project_scale: bool = True) -> QATOptimizer:
    """The partition of ``model``'s parameters, jaxlsq's ``qat_optimizer``:
    every ``FakeQuantize``'s ``scale``/``shift`` to ``qparams(params)``
    (default ``SGD(lr=qparam_lr, momentum=qparam_momentum)``, fused on a
    CUDA device; no weight decay), after a global-norm clip of their
    gradients to ``qparam_grad_clip`` (None: none), with the scales projected
    to at least the f32 eps when ``project_scale``; every other parameter to
    ``weights(params)``.  ``weights`` and ``qparams`` are optimizer factories,
    e.g. ``lambda ps: torch.optim.AdamW(ps, lr, capturable=True)``."""
    quantizers = [m for m in model.modules() if isinstance(m, FakeQuantize)]
    qps = [p for m in quantizers for p in (m.scale, m.shift)]
    q_ids = {id(p) for p in qps}
    ws = [p for p in model.parameters() if id(p) not in q_ids]
    if qparams is None:
        def qparams(ps):
            return torch.optim.SGD(ps, lr=qparam_lr, momentum=qparam_momentum,
                                   fused=ps[0].device.type == "cuda")
    return QATOptimizer(weights(ws) if ws else None, qparams(qps) if qps else None,
                        grad_clip=qparam_grad_clip,
                        scales=[m.scale for m in quantizers] if project_scale else ())
