"""FSDP / ZeRO-3 placement of a QAT model's parameters and optimizer state
(port of ``jaxlsq/parallel/fsdp.py``).

``fsdp_sharding`` keeps jaxlsq's rule: every parameter-like leaf of at least
``min_size`` elements is sharded over ``axis`` on its largest dimension
that the axis size divides; scalars, small leaves, leaves with no divisible
dimension and everything in the quantizer and BatchNorm collections
(``_REPLICATED_SCOPES``: a ``FakeQuantize``'s scale/shift are jaxlsq's
``qparams``, its buffers ``quant_state``, a BatchNorm's mean/var
``batch_stats``) are replicated.  The dimension is chosen on jaxlsq's
layout of the leaf (a conv kernel HWIO, a stock Linear's weight (K, N)) and
mapped to the port's, so the same axis is sharded.

``parallel.apply_sharding`` then keeps only this process's shard of each
sharded parameter (and of its optimizer state); ``make_train_step(mesh=,
state_sharding=)`` all-gathers the full weights at the start of the
forward and its backward reduce-scatters their gradients onto the shards
(hand-written ZeRO-3), so the step equals the replicated data-parallel
step while a process keeps about 1/N of the parameter and optimizer bytes.
"""

from __future__ import annotations

from typing import Dict, Tuple

from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..models.layers import FakeQuantize, QuantConv
from ..models.norm import BatchNorm
from ..models.quantize import QuantConv2d, QuantLinear

__all__ = ["fsdp_sharding"]

_REPLICATED_SCOPES = frozenset({"qparams", "quant_state", "batch_stats", "losses"})
# the layers whose weight the port lays out otherwise than jaxlsq: OIHW
# convolution kernels (jaxlsq: HWIO), (N, K) Linear weights (jaxlsq: (K, N))
_CONVS = (QuantConv, QuantConv2d, nn.Conv2d)
_LINEARS = (QuantLinear, nn.Linear)


def _collection(owner: nn.Module, is_param: bool) -> str:
    """The jaxlsq collection of a leaf of ``owner``."""
    if isinstance(owner, FakeQuantize):
        return "qparams" if is_param else "quant_state"
    if isinstance(owner, (BatchNorm, nn.modules.batchnorm._BatchNorm)) and not is_param:
        return "batch_stats"
    return "params" if is_param else "quant_state"


def jax_layout(owner: nn.Module, name: str, ndim: int) -> Tuple[int, ...]:
    """For each dim of jaxlsq's layout of the leaf ``name`` of ``owner``,
    the port's dim that holds it."""
    if ndim == 4 and name in ("kernel", "weight") and isinstance(owner, _CONVS):
        return (2, 3, 1, 0)  # HWIO from OIHW
    if ndim == 2 and name == "weight" and isinstance(owner, _LINEARS):
        return (1, 0)        # (K, N) from (N, K)
    return tuple(range(ndim))


def _named_leaves(model: nn.Module):
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            yield f"{mname}.{pname}" if mname else pname, mod, pname, p, True
        for bname, b in mod.named_buffers(recurse=False):
            if b is not None:
                yield f"{mname}.{bname}" if mname else bname, mod, bname, b, False


def fsdp_sharding(mesh: DeviceMesh, model: nn.Module, axis: str = "data",
                  min_size: int = 1024) -> Dict[str, tuple]:
    """A placement for each leaf of ``model``'s state dict: a tuple of one
    ``Shard(dim)``/``Replicate()`` per mesh axis (the ``DTensor``
    placements), each large parameter sharded over ``axis`` as jaxlsq's
    ``fsdp_sharding`` shards it."""
    names = mesh.mesh_dim_names
    i = names.index(axis)
    n = mesh.size(i)
    rep = tuple(Replicate() for _ in names)
    out = {}
    for name, owner, leaf, t, is_param in _named_leaves(model):
        out[name] = rep
        if _collection(owner, is_param) in _REPLICATED_SCOPES:
            continue
        if t.dim() == 0 or t.numel() < min_size:
            continue
        perm = jax_layout(owner, leaf, t.dim())
        shape = [t.shape[d] for d in perm]
        for d in sorted(range(len(shape)), key=lambda d: shape[d], reverse=True):
            if shape[d] % n == 0 and shape[d] >= n:
                out[name] = tuple(Shard(perm[d]) if k == i else Replicate()
                                  for k in range(len(names)))
                break
    return out
