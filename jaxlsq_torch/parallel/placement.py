"""Put a placement (``fsdp_sharding``, ``moe_sharding``: one
``Shard``/``Replicate`` per mesh axis for each state-dict leaf) into effect
on a model: the counterpart of jaxlsq's ``jax.device_put(state, sharding)``.

A sharded leaf keeps only this process's contiguous chunk, in place (the
``Parameter`` object stays, so an optimizer built before still holds it;
optimizer state already made for it is chunked the same way).  Two kinds:

* an expert stack (dim 0 of a leaf under a ``QuantMoE``'s experts, of the
  MoE's expert count): the MoE runs the local experts (``QuantMoE.ep``);
  its leaves are recorded in ``model._jlt_expert``;
* any other sharded parameter (FSDP): recorded in ``model._jlt_fsdp``;
  :func:`gathered_params` all-gathers it at use, with a backward that
  reduce-scatters the gradient onto the shard.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard

from .. import _dist
from ..models.moe import QuantMoE

__all__ = ["apply_sharding", "gathered_params"]


def _chunk(t: torch.Tensor, dim: int, size: int, rank: int) -> torch.Tensor:
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split over "
                         f"{size} processes")
    step = t.shape[dim] // size
    return t.narrow(dim, rank * step, step).clone()


def _owner(model: nn.Module, name: str):
    mname, _, leaf = name.rpartition(".")
    return (model.get_submodule(mname) if mname else model), leaf


@torch.no_grad()
def apply_sharding(model: nn.Module, sharding: Dict[str, tuple], mesh: DeviceMesh,
                   optimizer: Optional[torch.optim.Optimizer] = None) -> nn.Module:
    """Keep this process's shard of every leaf ``sharding`` shards (a leaf
    already sharded is left alone); returns ``model``."""
    fsdp = getattr(model, "_jlt_fsdp", {})
    expert = getattr(model, "_jlt_expert", {})
    experts = {}
    for moe in model.modules():
        if isinstance(moe, QuantMoE):
            for dense in (moe.experts_up, moe.experts_down):
                for t in list(dense.parameters()) + list(dense.buffers()):
                    experts[id(t)] = moe
    done = getattr(model, "_jlt_sharded", set())
    for name, placement in sharding.items():
        if name in done:
            continue
        axes = [(i, p.dim) for i, p in enumerate(placement) if isinstance(p, Shard)]
        if not axes:
            continue
        if len(axes) > 1:
            raise ValueError(f"{name}: sharded over more than one mesh axis")
        i, dim = axes[0]
        size, rank = mesh.size(i), mesh.get_local_rank(mesh.mesh_dim_names[i])
        owner, leaf = _owner(model, name)
        t = getattr(owner, leaf)
        full_shape = tuple(t.shape)
        moe = experts.get(id(t))
        new = _chunk(t.data, dim, size, rank)
        if isinstance(t, nn.Parameter):
            if optimizer is not None:
                st = optimizer.state.get(t, {})
                for k, v in st.items():
                    if torch.is_tensor(v) and tuple(v.shape) == full_shape:
                        st[k] = _chunk(v, dim, size, rank)
            t.data = new
        else:
            owner._buffers[leaf] = new
        done.add(name)
        part = _dist.Part(mesh.get_group(i), size, rank, dim)
        if moe is not None and dim == 0 and full_shape[0] == moe.num_experts:
            moe.ep = part
            expert[name] = part
        elif isinstance(t, nn.Parameter):
            fsdp[name] = part
        else:
            raise ValueError(f"{name}: only parameters and expert stacks can be "
                             "sharded")
    for moe in model.modules():
        if isinstance(moe, QuantMoE) and moe.ep is not None:
            for dense in (moe.experts_up, moe.experts_down):
                dense.set_local_experts(moe.ep)
    model._jlt_fsdp = fsdp
    model._jlt_expert = expert
    model._jlt_sharded = done
    return model


def gathered_params(model: nn.Module, grad: bool = True) -> Dict[str, torch.Tensor]:
    """The full tensor of each FSDP-sharded parameter, all-gathered (with a
    reduce-scatter backward when ``grad``)."""
    out = {}
    for name, part in getattr(model, "_jlt_fsdp", {}).items():
        p = model.get_parameter(name)
        out[name] = (_dist.all_gather_grad(p, part.group, part.size, part.dim) if grad
                     else _dist.all_gather(p, part.group, part.size, part.dim))
    return out



