"""Emulation of the per-tensor fake-quant backward's summation order
(``csrc/fake_quant.cu``: ``fq_bwd_pt``, ``fq_bwd_pt_traced`` and the fused
``fq_fwdbwd_pt``) on the CPU, for the test files that hold it: every step
one rounded f32 torch operation, as the kernel's ``_rn`` intrinsics.

The order depends on n alone:

* x is cut into tiles of ``TILE = 2048`` elements; ``blocks(n)`` = tiles / 4
  within [512, 2048] and at most one a tile, block b taking tiles b, b + B,
  ... in turn;
* in a tile, lane t of a block's 256 takes the groups of 4 at ``4 (256 j +
  t)``, j = 0, 1; a lane sums its elements in ascending index from +0;
* the pairwise tree (``v[k] += v[k + h]``, h halving) over a warp's 32
  lanes, then over the block's 8 warps: the block's partial;
* the last block folds the partials, padded with +0 to 2048: thread t takes
  partials ``t + 256 q``, q = 0 .. 7, by the pairwise tree over q, then the
  tree over a warp's lanes, then over the warps.

Each sum is then times ``gs`` (traced: ``(1 - ev) * gs``).  Padding is +0,
which changes no bits (no sum here is -0).  The JAX-free file keeps it
importable by ``tests/test_torch_gpu.py``.
"""

import torch

import _fq_pc_order as pc
from jaxlsq_torch.core.golden import effective_grad_scale

THREADS, GROUPS = 256, 2  # kThreads, kPtGroups
TILES_A_BLOCK, MIN_BLOCKS, MAX_BLOCKS = 4, 512, 2048  # kPtTilesABlock, kPtMin/MaxBlocks
TILE = THREADS * 4 * GROUPS
FOLD = MAX_BLOCKS // THREADS


def blocks(n):
    """The grid of a call over n elements, hence the number of partials:
    tiles / 4 within [512, 2048], at most one a tile."""
    tiles = max(1, -(-n // TILE))
    return min(tiles, MAX_BLOCKS, max(MIN_BLOCKS, tiles // TILES_A_BLOCK))


def terms(g, x, scale, shift, spec, init_mode=False):
    """The dS and dB term of every element of the flattened tensor, in the
    kernel's op sequence (dB: +0 where it adds none)."""
    flat = spec.replace(per_channel=False, axis=1)
    ds, db = pc.terms(g.reshape(1, 1, -1), x.reshape(1, 1, -1), scale.reshape(1),
                      shift.reshape(1), flat, init_mode)
    return ds.reshape(-1), db.reshape(-1)


def partials(t):
    """The blocks' partials of the flat terms ``t``, ``(blocks(n),)``."""
    n = t.numel()
    b = blocks(n)
    rounds = -(-n // (b * TILE))
    padded = torch.zeros(rounds * b * TILE)
    padded[:n] = t
    lanes = padded.view(rounds, b, GROUPS, THREADS, 4)
    acc = torch.zeros(b, THREADS)
    for r in range(rounds):
        for j in range(GROUPS):
            for e in range(4):
                acc = acc + lanes[r, :, j, :, e]
    return pc.tree(pc.tree(acc.view(b, THREADS // 32, 32)))


def fold(p):
    """The last block's fold of the partials."""
    padded = torch.zeros(MAX_BLOCKS)
    padded[:p.numel()] = p
    v = padded.view(FOLD, THREADS // 32, 32).permute(1, 2, 0)
    return pc.tree(pc.tree(pc.tree(v)))


def tensor_sum(t):
    """The sum of the flat terms ``t`` in the kernel's order."""
    return fold(partials(t))


def backward_sums(g, x, scale, shift, spec, init_mode=False, ev=None, numel=None):
    """``(dS, dB)`` as the card's per-tensor backward gives them, shaped like
    the qparams: static (``ev is None``; the fused kernel's too) or traced
    with flag ``ev``."""
    gs = torch.tensor(effective_grad_scale(spec, numel or x.numel()),
                      dtype=torch.float32)
    if ev is not None:
        gs = (torch.tensor(1.0) - torch.tensor(float(ev))) * gs
    ds, db = terms(g, x, scale, shift, spec, init_mode)
    return ((tensor_sum(ds) * gs).reshape(scale.shape),
            (tensor_sum(db) * gs).reshape(shift.shape))
