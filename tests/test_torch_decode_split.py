"""The split-L decode attention's summation order (``csrc/decode_attention.cu``),
emulated in torch on the CPU: 256-key spans from key 0, each walked in 64-key
tiles by an online softmax from m = -1e30 (scores as 8 head-dim slice dots
summed in one fixed tree, the -1e9 mask, a tile's sum of weights in one fixed
tree, the P.V sums as four chains over the tile's keys j = u mod 4 summed in
a fixed order), the span states (m, l, acc) left-folded in span order.

Held against ``decode_attention_plain`` within 1e-6 of max|ref| (f32, bf16,
int8 and int4 caches, GQA, windows that skip whole spans, ragged L), and
bitwise within itself: a row at B = 1 and B = 8, t = 32 in one call and in
four calls of 8, walking every span and tile (fully masked ones included)
and skipping them, a permuted page table and the dense layout.

Every exp runs on a contiguous tensor of a multiple of 64 and at most 32,768
elements, so PyTorch's CPU kernel takes its vectorized path for every element
whatever the row count (its scalar tail may round differently).
"""

import math

import numpy as np
import pytest
import torch

from jaxlsq_torch.serve.attention import MASK, _unpack4, decode_attention_plain

TILE, TILES_PER_SPAN, SLICES = 64, 4, 8
INIT = -1e30
ROW_CHUNK = 256  # rows an emulation step takes: (256, 64) = 16,384 elements


def _exp(x):
    flat = x.reshape(-1)
    n = flat.numel()
    pad = -n % 64
    flat = torch.cat([flat, flat.new_zeros(pad)])
    assert flat.numel() <= 32768
    return torch.exp(flat)[:n].reshape(x.shape)


def _tile_range(qp0, t, length, window):
    last = min(length - 1, qp0 + t - 1)
    first = max(0, qp0 - window + 1) if window else 0
    end = last // TILE
    return min(first // TILE, end), end


def _carrier(entry, dt=torch.float32):
    """(data as f32, per-key scale or None) of a cache entry (the layout the
    kernel reads: int4 interleaved nibbles)."""
    if not isinstance(entry, (tuple, list)):
        return entry.to(dt), None
    data = _unpack4(entry[0], dt) if entry[0].dtype == torch.uint8 else entry[0].to(dt)
    return data, entry[1].to(dt)


def _tree8(parts):
    """Lane 0 of the xor tree 4, 2, 1 over 8 lane partials."""
    a = [parts[i] + parts[i ^ 4] for i in range(4)]
    b = [a[i] + a[i ^ 2] for i in range(2)]
    return b[0] + b[1]


def _tree32(x):
    """Lane 0 of the xor tree 16 .. 1 over (rows, 32) lane values."""
    for o in (16, 8, 4, 2, 1):
        x = x[:, :o] + x[:, o:2 * o]
    return x[:, 0]


def split_attention(q, ck, cv, cache_index, window=None, *, table=None,
                    page_size=None, walk_all=False):
    """The kernels' order on (B, H, t, hd) queries against a dense cache
    (B, KVH, L, ...) or, with ``table`` (B, pps) and ``page_size``, page
    pools (P, KVH, ps, ...).  ``walk_all``: every row walks every tile of
    the cache and folds every span (none skipped)."""
    b, h, t, hd = q.shape
    kd, ksc = _carrier(ck)
    vd, vsc = _carrier(cv)
    kvh = kd.shape[1]
    g = h // kvh
    length = table.shape[1] * page_size if table is not None else kd.shape[2]
    dl = 8 if hd <= 64 else 16
    qpos = (torch.full((b,), cache_index, dtype=torch.int64)
            if isinstance(cache_index, int) else cache_index.to(torch.int64))
    # rows in the kernels' order: (b, kv head, query head, position)
    qr = q.reshape(b, kvh, g, t, hd).reshape(-1, hd)
    qr = torch.cat([qr, qr.new_zeros(qr.shape[0], SLICES * dl - hd)], 1)
    rb = torch.arange(b).repeat_interleave(kvh * g * t)
    rh = torch.arange(kvh).repeat_interleave(g * t).repeat(b)
    rpos = qpos[rb] + torch.arange(t).repeat(b * kvh * g)
    ranges = [_tile_range(int(p), t, length, window) for p in qpos]
    n_tiles = -(-length // TILE)
    if walk_all:
        ranges = [(0, n_tiles - 1)] * b
    tb = torch.tensor([r[0] for r in ranges])[rb]
    te = torch.tensor([r[1] for r in ranges])[rb]

    def rows_of(tile, sel):
        """(K, V, key scale, value scale) of ``tile`` for rows ``sel``, zero
        past L."""
        kpos = tile * TILE + torch.arange(TILE)
        live = kpos < length
        kp = kpos.clamp(max=length - 1)
        bb, hh = rb[sel][:, None], rh[sel][:, None]
        if table is None:
            idx = (bb, hh, kp[None, :])
        else:
            idx = (table.to(torch.int64)[bb, kp[None, :] // page_size], hh,
                   kp[None, :] % page_size)

        def take(x):
            if x is None:
                return None
            v = x[idx]
            mask = live.reshape(1, TILE, *([1] * (v.dim() - 2)))
            return torch.where(mask, v, v.new_zeros(()))

        return take(kd), take(vd), take(ksc), take(vsc)

    out = torch.empty(qr.shape[0], hd)
    scale = 1.0 / math.sqrt(hd)
    for c0 in range(0, qr.shape[0], ROW_CHUNK):
        sel = torch.arange(c0, min(c0 + ROW_CHUNK, qr.shape[0]))
        n = sel.numel()
        qc, posc, tbc, tec = qr[sel], rpos[sel], tb[sel], te[sel]
        fm, fl, fa = (torch.full((n,), INIT), torch.zeros(n), torch.zeros(n, hd))
        for span in range(-(-n_tiles // TILES_PER_SPAN)):
            m, l_, acc = torch.full((n,), INIT), torch.zeros(n), torch.zeros(n, hd)
            for tile in range(span * TILES_PER_SPAN, min(n_tiles, (span + 1) * TILES_PER_SPAN)):
                walk = (tile >= tbc) & (tile <= tec)
                if not walk.any():
                    continue
                kt, vt, kst, vst = rows_of(tile, sel)
                kt = torch.cat([kt, kt.new_zeros(n, TILE, SLICES * dl - hd)], 2)
                parts = []
                for sl in range(SLICES):
                    dot = torch.zeros(n, TILE)
                    for d in range(sl * dl, (sl + 1) * dl):
                        dot = dot + qc[:, d:d + 1] * kt[:, :, d]
                    parts.append(dot)
                s = _tree8(parts)
                if kst is not None:
                    s = s * kst
                s = s * scale
                kpos = tile * TILE + torch.arange(TILE)[None, :]
                ok = (kpos <= posc[:, None]) & (kpos < length)
                if window:
                    ok = ok & (kpos > posc[:, None] - window)
                s = torch.where(ok, s, torch.tensor(MASK, dtype=torch.float32))
                m_new = torch.maximum(m, s.amax(1))
                p = _exp(s - m_new[:, None])
                tsum = _tree32(p[:, :32] + p[:, 32:])
                alpha = _exp(m - m_new)
                if vst is not None:
                    p = p * vst
                chains = []
                for u in range(4):  # keys j = u mod 4, then (c0 + c1) + (c2 + c3)
                    c = torch.zeros(n, hd)
                    for j in range(u, TILE, 4):
                        c = c + p[:, j:j + 1] * vt[:, j]
                    chains.append(c)
                pv = (chains[0] + chains[1]) + (chains[2] + chains[3])
                w = walk[:, None]
                m = torch.where(walk, m_new, m)
                l_ = torch.where(walk, l_ * alpha + tsum, l_)
                acc = torch.where(w, acc * alpha[:, None] + pv, acc)
            folded = (span >= tbc // TILES_PER_SPAN) & (span <= tec // TILES_PER_SPAN)
            m2 = torch.maximum(fm, m)
            e, es = _exp(fm - m2), _exp(m - m2)
            fl = torch.where(folded, fl * e + l_ * es, fl)
            fa = torch.where(folded[:, None], fa * e[:, None] + acc * es[:, None], fa)
            fm = torch.where(folded, m2, fm)
        out[sel] = fa / fl[:, None]
    return out.reshape(b, kvh, g, t, hd).reshape(b, h, t, hd)


def _cache(r, carrier, b, kvh, length, hd):
    if carrier in ("f32", "bf16"):
        x = torch.from_numpy(r.standard_normal((b, kvh, length, hd)).astype(np.float32))
        return x if carrier == "f32" else x.to(torch.bfloat16)
    if carrier == "int8":
        data = torch.from_numpy(r.randint(-127, 128, (b, kvh, length, hd)).astype(np.int8))
    else:
        data = torch.from_numpy(r.randint(0, 256, (b, kvh, length, hd // 2)).astype(np.uint8))
    sc = torch.from_numpy((r.random_sample((b, kvh, length)) * 0.05).astype(np.float32))
    return data, sc


def _inputs(seed, carrier, b, h, kvh, length, t, hd=64):
    r = np.random.RandomState(seed)
    q = torch.from_numpy(r.standard_normal((b, h, t, hd)).astype(np.float32))
    ck, cv = (_cache(r, carrier, b, kvh, length, hd) for _ in "kv")
    idx = torch.from_numpy(r.randint(0, length - t + 1, size=b).astype(np.int32))
    return q, ck, cv, idx


def _slot(c, sl):
    return (c[0][sl], c[1][sl]) if isinstance(c, tuple) else c[sl]


@pytest.mark.parametrize("carrier", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("b,h,kvh,length,t,window,hd", [
    (2, 4, 2, 300, 3, None, 64),     # GQA, ragged L, one span and a part
    (2, 2, 2, 2047, 1, 300, 64),     # a window that skips whole spans
    (1, 4, 2, 700, 2, 200, 40),      # narrow head dim (zero-padded slices)
    (1, 2, 1, 520, 2, None, 100)])   # head dim > 64: 16-wide slices
def test_emulation_matches_plain(carrier, b, h, kvh, length, t, window, hd):
    q, ck, cv, idx = _inputs(length + t, carrier, b, h, kvh, length, t, hd)
    got = split_attention(q, ck, cv, idx, window)
    ref = decode_attention_plain(q, ck, cv, idx, window)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_rows_same_bits_at_b1_and_b8():
    q, ck, cv, idx = _inputs(1, "int8", 8, 4, 2, 2047, 1)
    full = split_attention(q, ck, cv, idx, 300)
    for s in (0, 3, 7):
        one = split_attention(q[s:s + 1], _slot(ck, slice(s, s + 1)),
                              _slot(cv, slice(s, s + 1)), idx[s:s + 1], 300)
        assert torch.equal(one, full[s:s + 1])


def test_prefill_in_chunks_same_bits_as_one_call():
    q, ck, cv, idx = _inputs(2, "bf16", 1, 2, 2, 600, 32)
    full = split_attention(q, ck, cv, idx, 100)
    parts = [split_attention(q[:, :, 8 * i:8 * i + 8], ck, cv, idx + 8 * i, 100)
             for i in range(4)]
    assert torch.equal(torch.cat(parts, dim=2), full)


@pytest.mark.parametrize("carrier,window", [("int4", 300), ("f32", None)])
def test_walking_masked_spans_same_bits_as_skipping(carrier, window):
    """Walking every tile and folding every span (those past the causal end,
    and with a window those before it) gives the skipping walk's bits."""
    q, ck, cv, idx = _inputs(3, carrier, 2, 2, 2, 1500, 2)
    idx = torch.tensor([900, 1200], dtype=torch.int32)
    skip = split_attention(q, ck, cv, idx, window)
    walk = split_attention(q, ck, cv, idx, window, walk_all=True)
    assert torch.equal(walk, skip)


@pytest.mark.parametrize("page_size", [7, 128])
def test_permuted_page_table_same_bits_as_dense(page_size):
    b, kvh, length, hd = 2, 2, 896, 64
    q, ck, cv, idx = _inputs(4, "int8", b, 4, kvh, length, 3)
    pps = -(-length // page_size)
    perm = torch.from_numpy(np.random.RandomState(5).permutation(b * pps + 2)[:b * pps])
    table = perm.reshape(b, pps).to(torch.int32)

    def pools(entry):  # dense rows scattered into the pages the table names
        def scatter(x):
            pad = pps * page_size - length
            x = torch.cat([x, x.new_zeros(*x.shape[:2], pad, *x.shape[3:])], 2)
            x = x.reshape(b, kvh, pps, page_size, *x.shape[3:]).movedim(2, 1)
            pool = x.new_zeros(b * pps + 2, kvh, page_size, *x.shape[4:])
            pool[table.to(torch.int64).reshape(-1)] = x.reshape(b * pps, kvh, page_size,
                                                                *x.shape[4:])
            return pool
        return tuple(scatter(x) for x in entry)

    dense = split_attention(q, ck, cv, idx, 200)
    paged = split_attention(q, pools(ck), pools(cv), idx, 200, table=table,
                            page_size=page_size)
    assert torch.equal(paged, dense)
