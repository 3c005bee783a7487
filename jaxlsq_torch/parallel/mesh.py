"""The device mesh of the multi-device steps (port of
``jaxlsq/parallel/mesh.py``): a ``torch.distributed`` ``DeviceMesh`` with the
named axes ``('data', 'model')`` over the processes, one device each.

* ``data``: data parallelism for QAT (the batch's rows over the processes,
  the gradients averaged over them);
* ``model``: tensor parallelism for serving (``serve.convert.shard_converted``),
  or the sequence axis of sequence-parallel training
  (``make_train_step(sequence_axis='model')``).

jaxlsq places global arrays and lets the compiler insert the collectives;
here each process holds its part (:func:`shard_batch`) and the steps issue
the collectives themselves (``jaxlsq_torch._dist``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

__all__ = ["make_mesh", "data_sharding", "replicated", "shard_batch",
           "initialize_distributed"]


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A (data, model) mesh over ``devices`` (process ranks, default every
    process of the default group); ``data=None`` takes all the remaining
    ones.  Every process of the default group must call it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized: "
                           "call initialize_distributed() first")
    devices = list(range(dist.get_world_size()) if devices is None else devices)
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    ranks = torch.tensor(devices[:data * model], dtype=torch.int64).reshape(data, model)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def data_sharding(mesh: DeviceMesh, ndim: int = 2):
    """The placements of a batch: its leading axis over 'data', replicated
    over the mesh's other axes (``ndim`` is jaxlsq's argument; a placement
    names only the split dim)."""
    return tuple(Shard(0) if name == "data" else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh):
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    """This process's device in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rows(t: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    size = t.shape[dim]
    if size % parts:
        raise ValueError(f"dim {dim} of size {size} does not split over {parts} "
                         "processes")
    step = size // parts
    return t.narrow(dim, index * step, step)


def shard_batch(batch: Dict[str, torch.Tensor], mesh: DeviceMesh,
                sequence_axis: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """This process's part of every tensor in ``batch``: the contiguous rows
    that ``P('data')`` gives its device, in the global row order, on its
    device; with ``sequence_axis`` also the contiguous part of dim 1 that
    ``P('data', sequence_axis)`` gives it."""
    device = _mesh_device(mesh)
    d, dr = mesh.size(mesh.mesh_dim_names.index("data")), mesh.get_local_rank("data")
    out = {}
    for k, v in batch.items():
        v = _rows(torch.as_tensor(v), 0, d, dr)
        if sequence_axis is not None:
            s = mesh.size(mesh.mesh_dim_names.index(sequence_axis))
            v = _rows(v, 1, s, mesh.get_local_rank(sequence_axis))
        out[k] = v.to(device).contiguous()
    return out


def initialize_distributed(device=None) -> Tuple[int, int]:
    """Multi-process bring-up from torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``; ``LOCAL_RANK`` picks the
    card): NCCL on a card, gloo when ``device='cpu'`` is asked for.  With
    no ``WORLD_SIZE`` set and no group up, a single-process no-op.  A group
    already up is kept, but if the environment asks for several processes
    and this one stays alone, that raises rather than train N independent
    copies.  Returns (rank, world size)."""
    want = os.environ.get("WORLD_SIZE")
    if want is not None and not dist.is_initialized():
        cpu = device is not None and torch.device(device).type == "cpu"
        if not cpu and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' explicitly to "
                "run the gloo backend on the CPU")
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("gloo" if cpu else "nccl", init_method="env://",
                                rank=int(os.environ.get("RANK", "0")),
                                world_size=int(want))
    if not dist.is_initialized():
        return 0, 1
    if int(want or "1") > 1 and dist.get_world_size() == 1:
        raise RuntimeError(f"WORLD_SIZE={want} asks for several processes, but "
                           "the process group already up holds one")
    return dist.get_rank(), dist.get_world_size()
