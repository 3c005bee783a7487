"""The collectives of the multi-device steps and the split of the rows they
run on.

jaxlsq's step under a mesh is its one-device step on the global batch: the
compiler traces it at the global shapes.  Here each process runs its own
rows, so whatever jaxlsq computes over the batch is reduced across the
processes that hold the other rows.  :class:`Split` says which those are:
one part per mesh axis the rows are spread over (the batch's dim 0 over
'data'; under sequence parallelism also dim 1 over 'model'; inside the
experts of an expert-parallel MoE dim 0 over 'expert').  The step opens it
with :func:`splitting`; the observers, the LSQ gradient scale, BatchNorm and
the MoE routing read :func:`current` and reduce over its groups.  Outside a
split nothing here is called and the one-device numbers are untouched.

Every collective goes through this module and adds one to ``COUNTS`` under
its kind, so a test can count what a forward or a step issued.  The
autograd-aware ones (:func:`all_reduce_grad`, :func:`all_gather_grad`)
carry the adjoint collective in their backward: an all-reduce's is an
all-reduce, an all-gather's a reduce-scatter.  With the adjoints exact,
each process's gradient holds its rows' share of every process's loss, and
the sum over the processes divided by their count is the gradient of the
global mean loss.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["COUNTS", "Part", "Split", "current", "splitting", "all_reduce",
           "all_gather", "all_reduce_grad", "all_gather_grad", "all_to_all_rows",
           "reduce_range", "reduce_sum", "mean_grad", "gather_global", "send", "recv",
           "broadcast"]

# collectives issued, by kind
COUNTS: collections.Counter = collections.Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class Part:
    """One mesh axis the rows are spread over: its process group, its size,
    this process's index in it, and the tensor dim it splits."""

    group: object
    size: int
    rank: int
    dim: int = 0


@dataclasses.dataclass(frozen=True)
class Split:
    """The parts of the global rows this process holds."""

    parts: Tuple[Part, ...]
    # whether weights are split too (an expert-parallel MoE's stacks), so a
    # weight quantizer's gradient scale counts the global elements
    weights: bool = False

    @property
    def factor(self) -> int:
        """How many times the local rows the global ones are."""
        f = 1
        for p in self.parts:
            f *= p.size
        return f


_SPLIT: contextvars.ContextVar = contextvars.ContextVar("split", default=None)


def current() -> Optional[Split]:
    return _SPLIT.get()


@contextlib.contextmanager
def splitting(split: Optional[Split]):
    """While open, :func:`current` is ``split`` (None: no split)."""
    token = _SPLIT.set(split)
    try:
        yield split
    finally:
        _SPLIT.reset(token)


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``t`` reduced in place over ``group``; returned."""
    COUNTS["all_reduce"] += 1
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group, size: int, dim: int = 0) -> torch.Tensor:
    """The ``size`` ranks' ``t`` concatenated along ``dim`` in rank order (no
    gradient)."""
    COUNTS["all_gather"] += 1
    src = t.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((size * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(t: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of ``t`` summed over ``group``, laid
    out in memory in ``t``'s order of dims, so that a reduction over it (a
    shared bias's gradient) runs in the order it runs over ``t``."""
    COUNTS["reduce_scatter"] += 1
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // size,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    out = out.movedim(0, dim)
    order = sorted(range(t.dim()), key=lambda i: -t.stride(i))
    if order == list(range(t.dim())):
        return out.contiguous()
    back = sorted(range(t.dim()), key=order.__getitem__)
    return out.new_empty([out.shape[i] for i in order]).permute(back).copy_(out)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t.clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), "sum", ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, size, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        return all_gather(t, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.size, ctx.dim), None, None, None


def all_reduce_grad(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``; its backward sums the gradients."""
    return _AllReduceSum.apply(t, group)


def all_gather_grad(t: torch.Tensor, group, size: int, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather` with a backward (a reduce-scatter of the
    gradient)."""
    return _AllGather.apply(t, group, size, dim)


def all_to_all_rows(t: torch.Tensor, send, recv, group) -> torch.Tensor:
    """Rows of ``t`` (dim 0) sent in rank order, ``send[q]`` rows to rank q,
    and ``recv[q]`` received from rank q, concatenated in rank order."""
    COUNTS["all_to_all"] += 1
    src = t.contiguous()
    out = src.new_empty((sum(recv),) + tuple(src.shape[1:]))
    dist.all_to_all_single(out, src, output_split_sizes=list(recv),
                           input_split_sizes=list(send), group=group)
    return out


def _host_staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses ``group`` through host memory: gloo's send and
    recv take CPU tensors only (PyTorch's backend table; a CUDA tensor
    aborts the process in gloo's TCP transport, "writev: Bad address", on
    torch 2.11), so a CUDA tensor is copied out and back under gloo.  NCCL
    moves it on the card, and gloo's collectives take CUDA tensors."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def send(t: torch.Tensor, dst: int, group) -> None:
    """Send ``t`` to rank ``dst`` of ``group`` (a group rank); waits until
    it is sent."""
    COUNTS["send"] += 1
    src = t.detach().contiguous()
    if _host_staged(src, group):
        src = src.cpu()
    dist.send(src, dst=dist.get_global_rank(group, dst), group=group)


def recv(shape, dtype, device, src: int, group) -> torch.Tensor:
    """A new tensor of ``shape``/``dtype`` on ``device``, received from rank
    ``src`` of ``group``."""
    COUNTS["recv"] += 1
    out = torch.empty(shape, dtype=dtype, device=device)
    buf = torch.empty(shape, dtype=dtype) if _host_staged(out, group) else out
    dist.recv(buf, src=dist.get_global_rank(group, src), group=group)
    return out.copy_(buf) if buf is not out else out


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` overwritten in place by rank ``src``'s (a group rank); returned."""
    COUNTS["broadcast"] += 1
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t


# ------------------------------------------------------ split reductions

def reduce_range(bmin: torch.Tensor, bmax: torch.Tensor, split: Split):
    """The global (min, max) of per-process batch ranges."""
    bmin, bmax = bmin.clone(), bmax.clone()
    for p in split.parts:
        all_reduce(bmin, "min", p.group)
        all_reduce(bmax, "max", p.group)
    return bmin, bmax


def reduce_sum(t: torch.Tensor, split: Split) -> torch.Tensor:
    """The sum of ``t`` over the split's processes (no gradient)."""
    t = t.clone()
    for p in split.parts:
        all_reduce(t, "sum", p.group)
    return t


def mean_grad(t: torch.Tensor, split: Split) -> torch.Tensor:
    """The mean over the split's processes of a per-process mean ``t`` (their
    rows are equal in number, so it is the global mean), with a backward."""
    for p in split.parts:
        t = all_reduce_grad(t, p.group)
    return t / float(split.factor)


def gather_global(x: torch.Tensor, split: Split) -> torch.Tensor:
    """The global tensor of the split's local pieces, in the global layout."""
    for p in reversed(split.parts):
        x = all_gather(x, p.group, p.size, p.dim)
    return x
