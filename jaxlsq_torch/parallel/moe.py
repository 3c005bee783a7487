"""Expert-parallel placement of a ``QuantMoE`` (port of
``jaxlsq/parallel/moe.py``).

``moe_sharding`` keeps jaxlsq's rule: a leaf under an expert scope
(``EXPERT_SCOPES``) that carries the stacked expert dim (shape[0] == E) is
sharded over ``axis`` on dim 0 — a kernel stack (E, K, N) (a packed one in
serve mode, with its per-expert scale and zero point), and the per-expert
1-D leaves of the quantizer collections (the weight quantizer's scale,
shift and observer range); a shared 1-D leaf (the bias) and everything
else are replicated.  ``parallel.apply_sharding`` keeps this process's
E/ep experts; ``QuantMoE`` then runs them on their global slots and
all-gathers their outputs (``models/moe.py``); no stack is gathered.  In a
step the expert leaves' gradients are reduced over the mesh's other axes
only.
"""

from __future__ import annotations

from typing import Dict

from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..models.layers import FakeQuantize
from .fsdp import _named_leaves

__all__ = ["moe_sharding", "EXPERT_SCOPES"]

EXPERT_SCOPES = ("experts_up", "experts_down")


def moe_sharding(mesh: DeviceMesh, model: nn.Module, num_experts: int,
                 axis: str = "expert") -> Dict[str, tuple]:
    """A placement for each leaf of ``model``'s state dict (one
    ``Shard``/``Replicate`` per mesh axis): the stacked expert leaves over
    ``axis``, the rest replicated."""
    names = mesh.mesh_dim_names
    i = names.index(axis)
    rep = tuple(Replicate() for _ in names)
    shard = tuple(Shard(0) if k == i else Replicate() for k in range(len(names)))
    quantish = {id(m) for q in model.modules() if isinstance(q, FakeQuantize)
                for m in q.modules()}
    out = {}
    for name, owner, leaf, t, is_param in _named_leaves(model):
        scopes = set(name.split("."))
        stacked = (t.dim() >= 1 and t.shape[0] == num_experts
                   and (id(owner) in quantish or t.dim() >= 2))
        out[name] = shard if stacked and scopes & set(EXPERT_SCOPES) else rep
    return out
