"""Emulation of ``wo8`` and ``wo4``'s tensor-core kernels (``csrc/mma_bf16.cuh``
as instanced in ``csrc/wo_matmul.cu``) on the CPU, for the test files that
hold their order: the kernels' bit operations on numpy ``uint32`` words, the
mma k index of each position, and the summation order.

A k-step is 16 positions j (mma.sync m16n8k16's k index).  ``wo8`` (int8,
16 weight rows a k-step): j is row 16 ks + j, k = 16 ks + j.  ``wo4``
(split-half int4, 8 byte rows a k-step): j < 8 is the low nibble of byte row
8 ks + j (k = 8 ks + j), j >= 8 the high nibble of byte row 8 ks + j - 8 (k
= ceil(K/2) + 8 ks + j - 8).  Slices are ``SLICE_STEPS`` k-steps.
"""

import numpy as np
import torch

SLICE_STEPS = 4  # k-steps (64 k) a slice


def step_rows(bits):
    return 16 if bits == 8 else 8


def lane_row(bits, i, t):
    """The weight row (within its k-step) of lane (g, t)'s read i."""
    return 2 * t + (i & 1) + 8 * (i >> 1) if bits == 8 else 2 * t + i


def positions(bits, k):
    """For every position of the padded k-steps: its k (or -1 where it is
    padding, which meets x = 0) and its weight row."""
    rows = k if bits == 8 else (k + 1) // 2
    per_slice = step_rows(bits) * SLICE_STEPS
    steps = -(-rows // per_slice) * SLICE_STEPS
    ks, j = np.divmod(np.arange(16 * steps), 16)
    if bits == 8:
        kk, row = 16 * ks + j, 16 * ks + j
        live = kk < k
    else:
        kr = (k + 1) // 2
        row = 8 * ks + j % 8
        kk = np.where(j < 8, row, kr + row)
        live = (row < kr) & (kk < k)
    return np.where(live, kk, -1), row


# ---- the kernels' bit operations ----

def byte_perm(x, y, sel):
    """CUDA's __byte_perm with selector nibbles below 8."""
    src = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)] + \
          [(y >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def bf16_bits_to_f32(h):
    return (np.asarray(h).astype(np.uint32) << np.uint32(16)).view(np.float32)


def bf16_round(v):
    """f32 values rounded to bf16 (to nearest even), back in f32."""
    return torch.from_numpy(np.array(v, np.float32)).to(torch.bfloat16).to(torch.float32).numpy()


def nibbles_zp(X, z):
    """wo4's decode of the nibbles at bits 0-3 and 16-19 of X less the zero
    point z: (the nibble ^ 8) at mantissa bits 3-6 of bf16 16.0, minus the
    bf16 24 + z (one bf16x2 subtract, rounded to nearest even)."""
    h = ((X << np.uint32(3)) & np.uint32(0x00780078)) ^ np.uint32(0x41C041C0)
    zc = np.float32(24) + np.asarray(z, np.float32)
    assert np.array_equal(bf16_round(zc), zc)  # the constant is a bf16
    lo = bf16_round(bf16_bits_to_f32(h & np.uint32(0xFFFF)) - zc)
    hi = bf16_round(bf16_bits_to_f32(h >> np.uint32(16)) - zc)
    return lo, hi


def bytes_zp(w0, w1, c, z):
    """wo8's decode of byte c of words w0 and w1 less the zero point z: each
    (2^23 + (byte ^ 0x80)) - (2^23 + 128 + z) in f32, then its top 16 bits
    (a byte permute, no rounding)."""
    zc = (np.int64(8388736) + np.asarray(z, np.int64)).astype(np.float32)
    out = []
    for w in (w0, w1):
        bits = byte_perm(w ^ np.uint32(0x80808080), np.uint32(0x4B000000), 0x7650 | c)
        f = bits.view(np.float32) - zc
        out.append(bf16_bits_to_f32(f.view(np.uint32) >> np.uint32(16)))
    return out[0], out[1]


def words(data, r, n):
    """The little-endian 32-bit word of bytes data[r, n .. n + 3] (0 past
    the rows or columns), for arrays r, n."""
    rows, cols = data.shape
    word = np.zeros(np.broadcast(r, n).shape, np.uint32)
    for j in range(4):
        c = n + j
        ok = (r < rows) & (c < cols)
        b = np.where(ok, data[np.minimum(r, rows - 1), np.minimum(c, cols - 1)], 0)
        word |= (b.astype(np.uint32) & np.uint32(0xFF)) << np.uint32(8 * j)
    return word


def emulate_a(data, bits, zp, wt, k):
    """The A operand every lane of every warp decodes (WT = ``wt`` m16 tiles
    a warp), scattered back through the k-step and column permutations: a
    (positions, N) f32 array.  data: the (rows, N) uint8 bytes; zp: (N,)
    int zero points."""
    n_cols = data.shape[1]
    kk, _ = positions(bits, k)
    steps = kk.size // 16
    cols = 16 * wt  # a warp's columns
    groups = -(-n_cols // cols)
    out = np.full((16 * steps, groups * cols), np.nan, np.float32)
    zfull = np.zeros(groups * cols, np.int64)
    zfull[:n_cols] = zp
    ks, wg = np.meshgrid(np.arange(steps), np.arange(groups), indexing="ij")
    nread = 4 if bits == 8 else 2
    for g in range(8):
        for t in range(4):
            r = [step_rows(bits) * ks + lane_row(bits, i, t) for i in range(nread)]
            for v in range(wt // 2):
                n = wg * cols + g * 2 * wt + 4 * v  # the word's first column
                w = [words(data, ri, n) for ri in r]
                for c in range(4):
                    q, e = 2 * v + c // 2, c % 2
                    col = wg * cols + g * 2 * wt + 2 * q + e
                    z = zfull[col]
                    if bits == 8:
                        regs = {e: bytes_zp(w[0], w[1], c, z), 2 + e: bytes_zp(w[2], w[3], c, z)}
                    else:
                        X = byte_perm(w[0], w[1], c | (c + 4) << 8)
                        regs = {e: nibbles_zp(X, z), 2 + e: nibbles_zp(X >> np.uint32(4), z)}
                    for reg, (lo, hi) in regs.items():
                        j = 2 * t + 8 * (reg // 2)  # a0/a1: j 2t, 2t+1; a2/a3: + 8
                        out[16 * ks + j, col] = lo
                        out[16 * ks + j + 1, col] = hi
    return out[:, :n_cols]


# ---- the order ----

def split3(x):
    """The kernels' three exact bf16 parts of f32 x."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    r = x - hi
    mid = r.to(torch.bfloat16).to(torch.float32)
    lo = (r - mid).to(torch.bfloat16).to(torch.float32)
    return hi, mid, lo


def factors(p):
    """(positions, N) f32: each position's factor w - z (0 where padding:
    such a position meets x = 0)."""
    k, n = p.orig_shape
    kk, _ = positions(p.bits, k)
    if p.bits == 8:
        q = p.data.to(torch.int32)
    else:
        lo = (p.data.to(torch.int32) << 28) >> 28
        q = torch.cat([lo, p.data.to(torch.int32) >> 4])[:k]
    z = p.zero_point.to(torch.int32)
    a = torch.zeros(kk.size, n)
    live = torch.from_numpy(kk >= 0)
    a[live] = (q[torch.from_numpy(kk[kk >= 0])] - z).to(torch.float32)
    return a


def emulate(x, p):
    """The kernels' result on f32 x (M, K) and a wo8 / wo4 pack: the exact
    products of three x parts and the factors, summed per slice (in f64,
    then rounded to f32: the tensor cores' own accumulation is not
    emulated), the even and the odd slices' partials each left-folded from
    +0 in f32, the two lanes added, times the scale."""
    k, n = p.orig_shape
    kk, _ = positions(p.bits, k)
    a = factors(p).double()
    xs = torch.zeros(x.shape[0], kk.size)
    xs[:, torch.from_numpy(kk >= 0)] = x[:, torch.from_numpy(kk[kk >= 0])]
    parts = split3(xs)
    lanes = [torch.zeros(x.shape[0], n), torch.zeros(x.shape[0], n)]
    width = 16 * SLICE_STEPS
    for s in range(kk.size // width):
        sl = slice(width * s, width * (s + 1))
        part = sum(pp[:, sl].double() @ a[sl] for pp in parts).float()
        lanes[s % 2] = lanes[s % 2] + part
    return (lanes[0] + lanes[1]) * p.scale.to(torch.float32)
