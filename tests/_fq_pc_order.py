"""Emulation of the per-channel fake-quant backward's summation order
(``csrc/fake_quant.cu``: ``fq_bwd_pc``, ``fq_bwd_pc_traced`` and the fused
``fq_fwdbwd_pc``) on the CPU, for the test files that hold it: every step
one rounded f32 torch operation, as the kernel's ``_rn`` intrinsics.

The plan ``(warps, cluster) = pc_plan(outer, C, inner)`` of the port fixes
the order from the shape alone:

* runs (``inner > 1``): a channel's ``m = outer * inner`` elements in walk
  order (o, then the run) are cut into groups of 4; lane ``G`` of ``P = 32 *
  warps * cluster`` (lane ``G = (rank * warps + warp) * 32 + lane``) sums the
  groups ``G, G + P, ...`` element by element from +0; then the pairwise tree
  (``v[k] += v[k + h]``, h halving) over a warp's 32 lanes, over the block's
  warps, over the cluster's blocks;
* rows (``inner == 1``): walker ``w = rank * 8 + warp`` of ``R = 8 *
  cluster`` sums rows ``w, w + R, ...`` of its channels from +0; then the
  pairwise tree over a block's 8 warps, then over the cluster's blocks.

Each sum is then times ``gs`` (traced: ``(1 - ev) * gs``).  Padding is +0,
which changes no bits (no sum here is -0).  The JAX-free file keeps it
importable by ``tests/test_torch_gpu.py``.
"""

import torch

from jaxlsq_torch.core.golden import effective_grad_scale
from jaxlsq_torch.ops.fake_quant import pc_plan

F32_EPS = 2.0 ** -23


def view3(shape, axis):
    axis %= len(shape)
    outer = 1
    for d in shape[:axis]:
        outer *= d
    inner = 1
    for d in shape[axis + 1:]:
        inner *= d
    return outer, shape[axis], inner


def terms(g, x, scale, shift, spec, init_mode=False):
    """The dS and dB term of every element, ``(outer, C, inner)`` each, in
    the kernel's op sequence (dB: +0 where it adds none)."""
    outer, c, inner = view3(tuple(x.shape), spec.axis)
    x = x.reshape(outer, c, inner).float()
    g = g.reshape(outer, c, inner).float()
    s = scale.float().abs().clamp_min(F32_EPS).view(1, c, 1)
    zp = torch.round(torch.clamp(-shift.float().view(1, c, 1) / s, float(spec.type_min),
                                 float(spec.type_max)))
    qmin, qmax = float(spec.quant_min), float(spec.quant_max)
    xq = torch.clamp(x / s + zp, qmin, qmax)
    inside = (qmin < xq) & (xq < qmax)
    xfq = (torch.round(xq) - zp) * s
    d = xfq - x
    geff = 2.0 * d if init_mode else g
    edge = torch.where(xq <= qmin, torch.tensor(qmin), torch.tensor(qmax))
    ds = torch.where(inside, (geff * d) / s, geff * (edge - zp))
    zero = torch.zeros((), dtype=torch.float32)
    db = zero.expand_as(ds) if spec.symmetric else torch.where(inside, zero, geff)
    return ds, db


def tree(v):
    """The pairwise tree over the last axis (a power of two long)."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def runs_sum(t, warps, cluster):
    outer, c, inner = t.shape
    m = outer * inner
    p = 32 * warps * cluster
    groups = -(-m // 4)
    nb = -(-groups // p)
    flat = torch.zeros(c, nb * p * 4)
    flat[:, :m] = t.permute(1, 0, 2).reshape(c, m)
    lane_groups = flat.view(c, nb, p, 4)
    acc = torch.zeros(c, p)
    for b in range(nb):
        for e in range(4):
            acc = acc + lane_groups[:, b, :, e]
    lanes = acc.view(c, cluster, warps, 32)
    return tree(tree(tree(lanes)))


def rows_sum(t, cluster):
    k, c, _ = t.shape
    r = 8 * cluster
    nb = -(-k // r)
    rows = torch.zeros(nb * r, c)
    rows[:k] = t[:, :, 0]
    acc = torch.zeros(r, c)
    for b in range(nb):
        acc = acc + rows[b * r:(b + 1) * r]
    return tree(tree(acc.view(cluster, 8, c).permute(2, 0, 1)))


def channel_sums(t):
    """The (C,) sums of ``(outer, C, inner)`` terms in the kernel's order."""
    outer, c, inner = t.shape
    warps, cluster = pc_plan(outer, c, inner)
    return rows_sum(t, cluster) if inner == 1 else runs_sum(t, warps, cluster)


def backward_sums(g, x, scale, shift, spec, init_mode=False, ev=None, numel=None):
    """``(dS, dB)`` as the card's per-channel backward gives them: static
    (``ev is None``; the fused kernel's too) or traced with flag ``ev``."""
    _, c, _ = view3(tuple(x.shape), spec.axis)
    gs = torch.tensor(effective_grad_scale(spec, numel or x.numel(), c),
                      dtype=torch.float32)
    if ev is not None:
        gs = (torch.tensor(1.0) - torch.tensor(float(ev))) * gs
    ds, db = terms(g, x, scale, shift, spec, init_mode)
    return channel_sums(ds) * gs, channel_sums(db) * gs
