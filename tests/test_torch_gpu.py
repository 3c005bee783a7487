"""jaxlsq_torch's CUDA kernels against their plain PyTorch versions on the
card, and the engine against ``make_generate`` on the card.  Marked ``gpu``:
they skip where there is no CUDA device.  This file imports no jax, so it
also runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: the K-sums of ``wo_matmul`` (``wo8``, ``wo4``, ``wo4g``) run in
f32 in another order than the plain matmul (``wo8``/``wo4`` with exact
products on the tensor cores; 1e-4 of the output's largest magnitude);
attention 1e-5; the paged kernel bit-equal to the dense kernel on
the gathered cache; the flash-attention kernels' out and lse 2e-5, dQ/dK/dV
1e-4 of the largest magnitude (3xTF32 products, tiled online softmax and sums
over t keys in another order), their backward bit-equal across runs;
captured train steps bit-equal to eager ones.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jaxlsq_torch import interop
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.models import QuantTransformerLM, default_qconfig, init_variables
from jaxlsq_torch.serve import DecodeEngine, convert, make_generate
from jaxlsq_torch.serve.attention import (LAUNCHES as ATTN_LAUNCHES,
                                          decode_attention, decode_attention_plain)
from jaxlsq_torch.serve.matmul import LAUNCHES as MM_LAUNCHES
from jaxlsq_torch.serve.matmul import wo_matmul, wo_matmul_plain
from jaxlsq_torch.serve.pack import quantize_weight, quantize_weight_grouped
from jaxlsq_torch.serve.paged import LAUNCHES as PAGED_LAUNCHES
from jaxlsq_torch.serve.paged import (PagedKVLayer, _gather_dense, paged_attention,
                                      paged_attention_plain, paged_update)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,n,m", [(1024, 1024, 1), (4096, 1024, 8),
                                   (1023, 520, 300), (33, 17, 5)])
def test_wo_matmul_kernel_matches_plain(cuda, bits, k, n, m):
    g = torch.Generator(device=cuda).manual_seed(k + m)
    spec = QuantSpec.weight_default(bits, per_channel=n % 2 == 0, axis=1)
    w = torch.randn(k, n, device=cuda, generator=g) * 0.05
    c = n if spec.per_channel else 1
    scale = (w.abs().amax(0) if spec.per_channel else w.abs().amax().reshape(1))
    p = quantize_weight(w, scale / spec.quant_max, torch.zeros(c, device=cuda),
                        spec, bits=bits)
    x = torch.randn(m, k, device=cuda, generator=g)
    key = "wo4" if bits == 4 else "wo8"
    before = MM_LAUNCHES[key]
    out = wo_matmul(x, p)
    ref = wo_matmul_plain(x, p)
    torch.cuda.synchronize()
    assert MM_LAUNCHES[key] == before + 1
    tol = 1e-4 * float(ref.abs().max())
    assert float((out - ref).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("carrier", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("b,h,kvh,length,t,window", [
    (1, 16, 16, 240, 1, None), (8, 16, 16, 2048, 1, None),
    (2, 16, 8, 240, 32, None), (2, 4, 4, 300, 3, 50)])
def test_decode_attention_kernel_matches_plain(cuda, carrier, b, h, kvh, length,
                                               t, window):
    g = torch.Generator(device=cuda).manual_seed(length + t)
    hd = 64
    q = torch.randn(b, h, t, hd, device=cuda, generator=g)

    def entry():
        if carrier in ("f32", "bf16"):
            dt = torch.float32 if carrier == "f32" else torch.bfloat16
            return torch.randn(b, kvh, length, hd, device=cuda, generator=g).to(dt)
        width, lo, hi, dt = ((hd, -127, 128, torch.int8) if carrier == "int8"
                             else (hd // 2, 0, 256, torch.uint8))
        return (torch.randint(lo, hi, (b, kvh, length, width), device=cuda,
                              generator=g).to(dt),
                torch.rand(b, kvh, length, device=cuda, generator=g) * 0.05)

    ck, cv = entry(), entry()
    idx = torch.randint(0, length - t + 1, (b,), device=cuda, generator=g).to(torch.int32)
    before = ATTN_LAUNCHES["decode_attention"]
    out = decode_attention(q, ck, cv, idx, window=window)
    ref = decode_attention_plain(q, ck, cv, idx, window=window)
    torch.cuda.synchronize()
    assert ATTN_LAUNCHES["decode_attention"] == before + 1
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,m,gs", [(1024, 3072, 1, 128), (4096, 1024, 8, 128),
                                      (1024, 8192, 256, 256), (512, 200, 300, 128)])
def test_wo4g_kernel_matches_plain(cuda, k, n, m, gs):
    g = torch.Generator(device=cuda).manual_seed(k + m)
    w = torch.randn(k, n, device=cuda, generator=g) * k ** -0.5
    p = quantize_weight_grouped(w, group_size=gs)
    x = torch.randn(m, k, device=cuda, generator=g)
    before = dict(MM_LAUNCHES)
    out = wo_matmul(x, p)
    ref = wo_matmul_plain(x, p)
    torch.cuda.synchronize()
    assert MM_LAUNCHES["wo4g"] == before["wo4g"] + 1 and MM_LAUNCHES["wo4"] == before["wo4"]
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("k,gs,bits", [(256, 64, 4), (384, 128, 4), (256, 128, 8)])
def test_wo4g_kernel_refuses_what_it_cannot_tile(cuda, k, gs, bits):
    """A group size or K / 2 off the kernel's 128-row chunks, or an int8
    grouped pack, raises on the card; nothing falls back."""
    w = torch.randn(k, 64, device=cuda)
    p = quantize_weight_grouped(w, group_size=gs, bits=bits)
    before = dict(MM_LAUNCHES)
    with pytest.raises(ValueError, match="multiples of 128"):
        wo_matmul(torch.randn(2, k, device=cuda), p)
    assert MM_LAUNCHES == before


def _pool_layer(carrier, b, kvh, length, hd, ps, g, device, spare=3):
    """A paged layer over a scrambled table with random rows in every pool
    page (written or not): B slots of ``length`` positions."""
    pps = -(-length // ps)
    n_pages = b * pps + spare
    table = torch.randperm(n_pages, generator=torch.Generator().manual_seed(ps))[
        :b * pps].reshape(b, pps).to(torch.int32).to(device)
    shape = (n_pages, kvh, ps)
    if carrier in ("f32", "bf16"):
        dt = torch.float32 if carrier == "f32" else torch.bfloat16
        pools = [torch.randn(shape + (hd,), device=device, generator=g).to(dt)
                 for _ in range(2)]
        return PagedKVLayer(kp=pools[0], vp=pools[1], table=table, page_size=ps)
    width, lo, hi, dt = ((hd, -127, 128, torch.int8) if carrier == "int8"
                         else (hd // 2, 0, 256, torch.uint8))
    data = [torch.randint(lo, hi, shape + (width,), device=device, generator=g).to(dt)
            for _ in range(2)]
    scales = [torch.rand(shape, device=device, generator=g) * 0.05 for _ in range(2)]
    return PagedKVLayer(kp=data[0], vp=data[1], ks=scales[0], vs=scales[1],
                        table=table, page_size=ps)


@pytest.mark.gpu
@pytest.mark.parametrize("carrier", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("b,h,kvh,length,ps,t,window", [
    (8, 16, 16, 2048, 128, 1, None), (8, 16, 16, 2048, 16, 32, 256),
    (1, 16, 16, 2048, 1024, 1, None), (2, 16, 8, 300, 7, 3, 50)])
def test_paged_attention_kernel_matches_plain_and_dense(cuda, carrier, b, h, kvh,
                                                        length, ps, t, window):
    g = torch.Generator(device=cuda).manual_seed(length + ps + t)
    hd = 64
    layer = _pool_layer(carrier, b, kvh, length, hd, ps, g, cuda)
    q = torch.randn(b, h, t, hd, device=cuda, generator=g)
    L = layer.length
    idx = torch.randint(0, L - t + 1, (b,), device=cuda, generator=g).to(torch.int32)
    before = dict(PAGED_LAUNCHES)
    out = paged_attention(q, layer, idx, window=window)
    ref = paged_attention_plain(q, layer, idx, window=window)
    ck, cv = _gather_dense(layer)
    dense = decode_attention(q, ck, cv, idx, window=window)
    torch.cuda.synchronize()
    assert PAGED_LAUNCHES["paged_attention"] == before["paged_attention"] + 1
    assert float((out - ref).abs().max()) <= 1e-5
    assert torch.equal(out, dense)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(1023, 1032), (1024, 1032), (4096, 1032), (8192, 1032),
                                 (1024, 3072), (1024, 8192)])
def test_wo8_rows_same_bits_at_every_m(cuda, k, n):
    """wo8 sums every output in one order on the tensor cores (x as three
    exact bf16 parts, exact (w - z) factors, 64-row K slices each the tensor
    cores' chain, the even and the odd slices folded in slice order into two
    f32 lanes, then added), so a row's bits do not depend on M or on the
    form that M picks (M = 1, 8, 16 the decode form, its K over a cluster;
    17, 100, 256, 300 the tiled form: 16-row tiles at N = 1032, 64-row
    tiles at N = 8192, M = 256) or on the run; one launch a call; within
    1e-4 of plain.  N = 1032: 16-byte rows, a ragged last column tile."""
    from jaxlsq_torch.serve.pack import PackedWeight

    g = torch.Generator(device=cuda).manual_seed(k + n)
    p = PackedWeight(
        data=torch.randint(-128, 128, (k, n), device=cuda, generator=g).to(torch.int8),
        scale=torch.rand(n, device=cuda, generator=g) * 1e-2 + 1e-3,
        zero_point=torch.randint(-5, 6, (n,), device=cuda, generator=g).to(torch.int32),
        bits=8, axis=1, k_axis=0, orig_shape=(k, n))
    x = torch.randn(300, k, device=cuda, generator=g)
    full = wo_matmul(x, p)
    ref = wo_matmul_plain(x, p)
    for m in (1, 8, 16, 17, 100, 256, 300):
        before = MM_LAUNCHES["wo8"]
        out = wo_matmul(x[:m], p)
        torch.cuda.synchronize()
        assert MM_LAUNCHES["wo8"] == before + 1
        assert torch.equal(out, full[:m]), m
    assert torch.equal(wo_matmul(x, p), full)
    assert float((full - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("kind,k,n,per_channel,gs", [
    ("wo4", 1023, 1032, True, None), ("wo4", 1024, 1032, False, None),
    ("wo4", 4096, 1032, True, None), ("wo4", 1024, 3072, True, None),
    ("wo4", 1024, 8192, True, None), ("wo4g", 1024, 1032, True, 128),
    ("wo4g", 1024, 1032, True, 256), ("wo4g", 4096, 1032, True, 128),
    ("wo4g", 1024, 8192, True, 128), ("wo4g", 8192, 1032, True, 256)])
def test_wo4_rows_same_bits_at_every_m(cuda, kind, k, n, per_channel, gs):
    """wo4 sums every output in one order on the tensor cores (wo8's: 64-k
    slices of a k-step's low then high nibbles, x as three exact bf16 parts,
    exact (v - z) factors, two f32 lanes of slices folded in slice order);
    wo4g in its f32 order (32-byte-row slices, each byte row's low nibble
    and then its high nibble, folded in slice order).  So a row's bits do
    not depend on M or on the form that M picks (wo4: M = 1, 8, 16 decode,
    17, 100, 256, 300 tiled; wo4g: 1, 8, 16, 17 split, 100, 256, 300 tiled)
    or on the run; one launch a call; within 1e-4 of plain.  Random bytes
    (for odd K the last byte row's high nibble too, which both sides drop),
    a nonzero zero point (wo4), N = 1032 a ragged last column tile."""
    from jaxlsq_torch.serve.pack import PackedWeight

    g = torch.Generator(device=cuda).manual_seed(k + n + (gs or 0))
    c = n if per_channel and not gs else 1
    p = PackedWeight(
        data=torch.randint(-128, 128, ((k + 1) // 2, n), device=cuda,
                           generator=g).to(torch.int8),
        scale=(torch.rand((k // gs, n) if gs else (c,), device=cuda, generator=g)
               * 1e-2 + 1e-3),
        zero_point=(torch.zeros(1, dtype=torch.int32, device=cuda) if gs else
                    (torch.randint(1, 6, (c,), device=cuda, generator=g)
                     * (1 - 2 * (torch.arange(c, device=cuda) % 2))).to(torch.int32)),
        bits=4, axis=1, k_axis=0, orig_shape=(k, n), group_size=gs)
    x = torch.randn(300, k, device=cuda, generator=g)
    full = wo_matmul(x, p)
    ref = wo_matmul_plain(x, p)
    for m in (1, 8, 16, 17, 100, 256, 300):
        before = dict(MM_LAUNCHES)
        out = wo_matmul(x[:m], p)
        torch.cuda.synchronize()
        assert MM_LAUNCHES == {**before, kind: before[kind] + 1}
        assert torch.equal(out, full[:m]), m
    assert torch.equal(wo_matmul(x, p), full)
    assert float((full - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(1024, 1032), (4095, 520)])
def test_wo8_extreme_bytes_and_zero_points(cuda, k, n):
    """wo8 with bytes at -128 and 127 beside random ones and zero points at
    the int8 carrier's ends (-128, 127) and between, per channel: w - z
    spans [-255, 255], every factor exact in bf16; within 1e-4 of plain at
    M on both sides of the form threshold, and a row's bits at every M."""
    from jaxlsq_torch.serve.pack import PackedWeight

    g = torch.Generator(device=cuda).manual_seed(k)
    data = torch.randint(-128, 128, (k, n), device=cuda, generator=g)
    ends = torch.randint(0, 3, (k, n), device=cuda, generator=g)
    data = torch.where(ends == 0, -128, torch.where(ends == 1, 127, data)).to(torch.int8)
    zp = torch.randint(-128, 128, (n,), device=cuda, generator=g)
    zp[0::4], zp[1::4] = -128, 127
    p = PackedWeight(data=data, scale=torch.rand(n, device=cuda, generator=g) * 1e-3 + 1e-4,
                     zero_point=zp.to(torch.int32), bits=8, axis=1, k_axis=0,
                     orig_shape=(k, n))
    x = torch.randn(40, k, device=cuda, generator=g)
    full = wo_matmul(x, p)
    ref = wo_matmul_plain(x, p)
    assert float((full - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    for m in (1, 16, 17):
        out = wo_matmul(x[:m], p)
        assert float((out - ref[:m]).abs().max()) <= 1e-4 * float(ref[:m].abs().max()), m
        assert torch.equal(out, full[:m]), m


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_wo_rows_same_bits_across_cluster_sizes(cuda, bits):
    """wo8 and wo4's decode form splits K over a cluster whose size follows
    the column tiles: at K = 4096 (64 slices) the full N = 34816 (272 tiles
    of 128, more than the card holds at once in clusters of two) takes one
    block a tile, its first 1032 columns (9 tiles) a larger cluster; both
    give the same bits in those columns at M = 1 and 16, and so does the
    tiled form at M = 17."""
    from jaxlsq_torch.serve.pack import PackedWeight

    k, n, part = 4096, 34816, 1032
    g = torch.Generator(device=cuda).manual_seed(bits)
    rows = k if bits == 8 else k // 2
    data = torch.randint(-128, 128, (rows, n), device=cuda, generator=g).to(torch.int8)
    scale = torch.rand(n, device=cuda, generator=g) * 1e-2 + 1e-3
    zp = torch.randint(-5, 6, (n,), device=cuda, generator=g).to(torch.int32)
    p = PackedWeight(data, scale, zp, bits, 1, 0, (k, n))
    q = PackedWeight(data[:, :part].contiguous(), scale[:part].contiguous(),
                     zp[:part].contiguous(), bits, 1, 0, (k, part))
    x = torch.randn(17, k, device=cuda, generator=g)
    for m in (1, 16, 17):
        assert torch.equal(wo_matmul(x[:m], p)[:, :part], wo_matmul(x[:m], q)), m


@pytest.mark.gpu
def test_wo_kernels_use_tensor_cores(cuda):
    """Every instance of wo8 and wo4's two forms (``csrc/wo_matmul.cu`` on
    ``csrc/mma_bf16.cuh``: the decode form at 2 n8 tiles of rows on
    64-column tiles of 8 warps, at 1 n8 tile on 64-column tiles of 8 and 4
    warps and, wo4 only, 128-column tiles of 8; the tiled form at 64- and
    16-row tiles) runs its products as bf16 HMMA, as the built library's
    SASS shows."""
    import os
    import shutil

    from jaxlsq_torch import _build

    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        pytest.skip("the CUDA toolkit has no cuobjdump")
    funcs = _sass_functions(_build.load_library()._name, cuobjdump)
    found = {k: v for k, v in funcs.items()
             if "wo_mma_decode_kernel" in k or "wo_mma_tiled_kernel" in k}
    assert len(found) == (3 + 2) + (4 + 2), list(found)
    for name, sass in found.items():
        assert any("HMMA" in ln and "BF16" in ln for ln in sass.splitlines()), name


def _attention_pair(carrier, b, kvh, length, hd, ps, g, device):
    """A paged layer over a permuted table and its gathered dense cache."""
    layer = _pool_layer(carrier, b, kvh, length, hd, ps, g, device)
    return layer, _gather_dense(layer)


@pytest.mark.gpu
@pytest.mark.parametrize("carrier", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("length,window,ps", [(2048, None, 128), (2047, 300, 7),
                                              (1100, 64, 16)])
def test_attention_rows_same_bits_across_batch_and_chunks(cuda, carrier, length,
                                                          window, ps):
    """A row of the split-L kernels gets the same bits at B = 8 as at B = 1,
    and t = 32 in one call the same bits as four calls of 8, dense and paged
    (paged bit-equal to dense)."""
    g = torch.Generator(device=cuda).manual_seed(length + ps)
    b, h, kvh, hd, t = 8, 8, 4, 64, 32
    layer, (ck, cv) = _attention_pair(carrier, b, kvh, length, hd, ps, g, cuda)
    L = layer.length
    q = torch.randn(b, h, t, hd, device=cuda, generator=g)
    idx = torch.randint(0, min(L, length) - t + 1, (b,), device=cuda,
                        generator=g).to(torch.int32)
    for kind, run in (("dense", lambda q_, sl, i: decode_attention(
                          q_, _slot(ck, sl), _slot(cv, sl), i, window=window)),
                      ("paged", lambda q_, sl, i: paged_attention(
                          q_, dataclasses.replace(layer, table=layer.table[sl]), i,
                          window=window))):
        full = run(q, slice(None), idx)
        for s in (0, 5):
            one = run(q[s:s + 1], slice(s, s + 1), idx[s:s + 1])
            assert torch.equal(one, full[s:s + 1]), (kind, s)
        parts = [run(q[:, :, 8 * i:8 * i + 8].contiguous(), slice(None), idx + 8 * i)
                 for i in range(4)]
        assert torch.equal(torch.cat(parts, dim=2), full), kind
        if kind == "dense":
            dense = full
    assert torch.equal(full, dense)
    ref = decode_attention_plain(q, ck, cv, idx, window=window)
    assert float((dense - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))


def _slot(c, sl):
    return (c[0][sl], c[1][sl]) if isinstance(c, tuple) else c[sl]


@pytest.mark.gpu
@pytest.mark.parametrize("carrier", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("length,t,window,ps", [
    (8192, 1, None, 128), (8192, 4, None, 16), (2047, 1, 300, 7), (2047, 3, 300, 16),
    (2047, 1, 300, 128)])
def test_split_attention_long_and_windowed(cuda, carrier, length, t, window, ps):
    """L = 8192 (32 spans) and a 300-key window over L = 2047 that skips whole
    spans: paged bit-equal to dense and within 1e-5 of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(length + t + ps)
    b, h, kvh, hd = 2, 16, 8, 64
    layer, (ck, cv) = _attention_pair(carrier, b, kvh, length, hd, ps, g, cuda)
    q = torch.randn(b, h, t, hd, device=cuda, generator=g)
    idx = torch.tensor([length - t, length // 2], dtype=torch.int32, device=cuda)
    before = dict(ATTN_LAUNCHES), dict(PAGED_LAUNCHES)
    dense = decode_attention(q, ck, cv, idx, window=window)
    paged = paged_attention(q, layer, idx, window=window)
    ref = decode_attention_plain(q, ck, cv, idx, window=window)
    torch.cuda.synchronize()
    assert ATTN_LAUNCHES["decode_attention"] == before[0]["decode_attention"] + 1
    assert PAGED_LAUNCHES["paged_attention"] == before[1]["paged_attention"] + 1
    assert ATTN_LAUNCHES["decode_attention_fold"] == before[0]["decode_attention_fold"] + 1
    assert PAGED_LAUNCHES["paged_attention_fold"] == before[1]["paged_attention_fold"] + 1
    assert torch.equal(paged, dense)
    assert float((dense - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [40, 33, 100, 128])
def test_split_attention_other_head_dims(cuda, hd):
    """Head dims that are not a multiple of 16 bytes take narrower copies;
    every carrier within 1e-5 of plain (int4 at even hd)."""
    g = torch.Generator(device=cuda).manual_seed(hd)
    for carrier in ("f32", "bf16", "int8", "int4"):
        if carrier == "int4" and hd % 2:
            continue
        layer, (ck, cv) = _attention_pair(carrier, 2, 2, 600, hd, 16, g, cuda)
        q = torch.randn(2, 4, 2, hd, device=cuda, generator=g)
        idx = torch.tensor([598, 300], dtype=torch.int32, device=cuda)
        dense = decode_attention(q, ck, cv, idx)
        paged = paged_attention(q, layer, idx)
        ref = decode_attention_plain(q, ck, cv, idx)
        assert torch.equal(paged, dense), carrier
        assert float((dense - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max())), carrier


@pytest.mark.gpu
def test_paged_attention_refuses_what_it_cannot_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    layer = _pool_layer("int8", 2, 4, 64, 64, 16, g, cuda)
    q = torch.randn(2, 4, 1, 64, device=cuda)
    idx = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = dict(PAGED_LAUNCHES)
    for bad, match in (
            (dict(table=layer.table.to(torch.int64)), "int32"),
            (dict(table=layer.table[:1]), "int32"),
            (dict(ks=None, vs=None), "scale"),
            (dict(vp=layer.vp.to(torch.int32)), "dtypes")):
        with pytest.raises(ValueError, match=match):
            paged_attention(q, dataclasses.replace(layer, **bad), idx)
    with pytest.raises(ValueError, match="f32 queries"):
        paged_attention(q.to(torch.bfloat16), layer, idx)
    with pytest.raises(ValueError, match="device"):
        paged_attention(q, dataclasses.replace(layer, table=layer.table.cpu()), idx)
    assert PAGED_LAUNCHES == before


@pytest.mark.gpu
def test_quantize_on_card_gives_the_cpu_bits(cuda):
    """Group scales and the KV caches' quantize-on-write divide by their
    qmax as a true division on the card too, so a pack or a cache row has
    the same bits on the card as on the CPU."""
    from jaxlsq_torch.serve.attention import _q4, _q8

    g = torch.Generator(device=cuda).manual_seed(9)
    w = torch.randn(1024, 512, device=cuda, generator=g)
    a, b = quantize_weight_grouped(w, group_size=128), quantize_weight_grouped(
        w.cpu(), group_size=128)
    assert torch.equal(a.data.cpu(), b.data) and torch.equal(a.scale.cpu(), b.scale)
    k = torch.randn(8, 16, 64, 64, device=cuda, generator=g)
    for quant in (_q8, _q4):
        (da, sa), (db, sb) = quant(k), quant(k.cpu())
        assert torch.equal(da.cpu(), db) and torch.equal(sa.cpu(), sb)


@pytest.mark.gpu
def test_paged_update_matches_dense_write_on_card(cuda):
    """The same rows written through a scrambled table and into a dense
    cache: the gathered pools hold the dense cache's bytes."""
    from jaxlsq_torch.models.zoo import _write
    from jaxlsq_torch.serve.attention import _q8

    g = torch.Generator(device=cuda).manual_seed(5)
    layer = _pool_layer("int8", 2, 4, 64, 64, 16, g, cuda)
    k = torch.randn(2, 4, 5, 64, device=cuda, generator=g)
    idx = torch.tensor([3, 40], dtype=torch.int32, device=cuda)
    paged_update(layer, k, -k, idx)
    (kd, ks), _ = _gather_dense(layer)
    dk, dks = kd.clone(), ks.clone()
    kq, kscale = _q8(k)
    _write(dk, kq, idx, 5)
    _write(dks, kscale, idx, 5)
    assert torch.equal(kd, dk) and torch.equal(ks, dks)


@pytest.mark.gpu
def test_paged_engine_equals_dense_engine_on_card(cuda):
    """Group-wise int4 weights, int8 pools under-provisioned: the paged
    engine's tokens equal the dense engine's, through wo4g and the paged
    kernel (one summation order for every batch and page layout)."""
    from jaxlsq_torch.serve import PagedDecodeEngine

    m = QuantTransformerLM(256, 256, 2, 4, default_qconfig(4, 8).for_serving(),
                           max_len=128, device=cuda)
    interop.load_variables(m, convert(init_variables(m, seed=1), m.qconfig,
                                      weight_group_size=128))
    r = np.random.RandomState(0)
    prefix = r.randint(0, 256, size=20)
    reqs = [(r.randint(0, 256, size=r.randint(3, 17)), int(r.randint(4, 40)))
            for _ in range(6)]
    outs = {}
    for kind in ("dense", "paged"):
        before = dict(MM_LAUNCHES), dict(PAGED_LAUNCHES)
        kw = dict(max_batch=4, prompt_buckets=(8, 16), prefill_chunk=8,
                  cache_dtype=torch.int8)
        eng = (DecodeEngine(m, **kw) if kind == "dense" else
               PagedDecodeEngine(m, num_pages=8, page_size=16, **kw))
        with eng:
            h = eng.register_prefix(prefix)
            futs = [eng.submit(p, n, prefix=h if i % 2 else None)
                    for i, (p, n) in enumerate(reqs)]
            outs[kind] = [f.result(timeout=300) for f in futs]
            stats = dict(eng.stats)
        assert MM_LAUNCHES["wo4g"] > before[0]["wo4g"]
        assert MM_LAUNCHES["wo4"] == before[0]["wo4"]
        if kind == "paged":
            assert PAGED_LAUNCHES["paged_attention"] > before[1]["paged_attention"]
            assert stats["admissions_deferred"] > 0 and stats["prefix_pages_shared"] > 0
    for a, b in zip(outs["dense"], outs["paged"]):
        np.testing.assert_array_equal(b, a)


@pytest.mark.gpu
def test_engine_equals_generate_on_card(cuda):
    """Rows are reduced in a fixed order whatever the batch, so the engine
    (decode at B = max_batch, prefill in B = 1 chunks) gives make_generate's
    B = 1 tokens on the card."""
    m = QuantTransformerLM(256, 128, 2, 4, default_qconfig(8, 8).for_serving(),
                           max_len=64, device=cuda)
    interop.load_variables(m, init_variables(m, seed=1))
    r = np.random.RandomState(0)
    reqs = [(r.randint(0, 256, size=r.randint(3, 17)), int(r.randint(4, 12)))
            for _ in range(5)]
    with DecodeEngine(m, max_batch=4, prompt_buckets=(8, 16), prefill_chunk=8,
                      cache_dtype=torch.bfloat16) as eng:
        outs = [f.result(timeout=300) for f in [eng.submit(p, n) for p, n in reqs]]
    for (p, n), got in zip(reqs, outs):
        want = make_generate(m, len(p), n, cache_dtype=torch.bfloat16)(
            torch.as_tensor(p, device=cuda)[None])
        np.testing.assert_array_equal(got, want[0].cpu().numpy())


FQ_SPECS = {
    "act": dict(quant_min=0, quant_max=127, type_min=0, type_max=255),
    "sym": dict(quant_min=-127, quant_max=127, symmetric=True),
    "w_oihw": dict(quant_min=-127, quant_max=127, symmetric=True, per_channel=True,
                   axis=0),
    "w_kn": dict(quant_min=-127, quant_max=127, symmetric=True, per_channel=True,
                 axis=1),
    "aff_nchw": dict(quant_min=0, quant_max=255, per_channel=True, axis=1),
}
STATIC_FQ = ("fq_fwd_pt", "fq_fwd_pc", "fq_bwd_pt", "fq_bwd_pc")
FQ_SHAPES = {"act": [(64, 3, 32, 32), (64, 512, 4, 4), (64, 512), (3,), (33, 7, 5)],
             "sym": [(64, 64, 32, 32), (1000,)],
             "w_oihw": [(512, 512, 3, 3), (64, 3, 3, 3), (128, 64, 1, 1), (5, 3, 1, 1),
                        (16, 64, 3, 3), (1,)],
             "w_kn": [(512, 10), (33, 300), (512, 8192), (17, 12), (40, 1)],
             "aff_nchw": [(8, 16, 5, 5), (3, 7, 4, 4), (2, 1, 4098)]}


def _fq_abs_sums(g, x, s, b, spec, init_mode, gs):
    """gs times the sum of |term| of dS and of dB per qparam, in f64: the
    scale of a summation-order difference."""
    from jaxlsq_torch.core.golden import broadcast_qparams

    x, g = x.double(), g.double()
    s = s.double().abs().clamp_min(2.0 ** -23)
    b = b.double()
    axis = spec.axis % x.dim() if spec.per_channel else None
    if axis is not None:
        s, b = (broadcast_qparams(t, x.dim(), axis) for t in (s, b))
    zp = torch.round(torch.clamp(-b / s, spec.type_min, spec.type_max))
    xq = torch.clamp(x / s + zp, spec.quant_min, spec.quant_max)
    m = (spec.quant_min < xq) & (xq < spec.quant_max)
    xfq = (torch.round(xq) - zp) * s
    geff = 2 * (xfq - x) if init_mode else g
    ds = torch.where(m, geff * (xfq - x) / s,
                     torch.where(xq <= spec.quant_min, geff * (spec.quant_min - zp),
                                 geff * (spec.quant_max - zp))).abs()
    db = torch.where(m, 0.0, geff).abs()
    red = tuple(a for a in range(x.dim()) if a != axis)
    return ds.sum(dim=red) * abs(gs), db.sum(dim=red) * abs(gs)


@pytest.mark.gpu
@pytest.mark.parametrize("eval_mode,init_mode", [(False, False), (True, False),
                                                 (False, True)])
@pytest.mark.parametrize("name,shape", [(k, s) for k, v in FQ_SHAPES.items() for s in v])
def test_fake_quant_kernels_match_plain(cuda, name, shape, eval_mode, init_mode):
    """Forward and dX bit-exact; dS/dB within 1e-5 of the sum of |terms|."""
    from jaxlsq_torch.core.golden import effective_grad_scale
    from jaxlsq_torch.ops.fake_quant import (LAUNCHES, fake_quant_backward,
                                             fake_quant_forward)

    spec = QuantSpec(**FQ_SPECS[name])
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, device=cuda, generator=g) * 1.5
    c = shape[spec.axis] if spec.per_channel else 1
    s = 0.01 + 0.04 * torch.rand(c, device=cuda, generator=g)
    b = (torch.zeros(c, device=cuda) if spec.symmetric
         else 0.2 * torch.randn(c, device=cuda, generator=g))
    gr = torch.randn(shape, device=cuda, generator=g)
    kind = "pc" if spec.per_channel else "pt"
    before = dict(LAUNCHES)
    out = fake_quant_forward(x, s, b, spec, init_mode)
    dx, ds, db = fake_quant_backward(gr, x, s, b, spec, eval_mode, init_mode)
    torch.cuda.synchronize()
    assert LAUNCHES[f"fq_fwd_{kind}"] == before[f"fq_fwd_{kind}"] + (0 if init_mode else 1)
    assert LAUNCHES[f"fq_bwd_{kind}"] == before[f"fq_bwd_{kind}"] + 1
    ref = fake_quant_forward(*(t.cpu() for t in (x, s, b)), spec, init_mode)
    rdx, rds, rdb = fake_quant_backward(*(t.cpu() for t in (gr, x, s, b)), spec,
                                        eval_mode, init_mode)
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(dx.cpu(), rdx)
    gs = effective_grad_scale(spec, x.numel(), c)
    sums = _fq_abs_sums(gr.cpu(), x.cpu(), s.cpu(), b.cpu(), spec, init_mode, gs)
    for got, want, tot in ((ds, rds, sums[0]), (db, rdb, sums[1])):
        err = (got.cpu().double() - want.double()).abs()
        assert bool((err <= 1e-5 * tot.reshape(err.shape)).all()), (err.max(), tot.max())
        if eval_mode:
            assert not got.any()


@pytest.mark.gpu
def test_fake_quant_kernels_refuse_other_dtypes(cuda):
    """float64 is refused on the card (16-bit inputs are widened to f32 at
    the boundary: test_fake_quant_sixteen_bit_on_card_matches_cpu)."""
    from jaxlsq_torch.ops.fake_quant import (fake_quant_backward, fake_quant_forward,
                                             fake_quant_fwdbwd)

    spec = QuantSpec(**FQ_SPECS["act"])
    x = torch.randn(8, 16, device=cuda, dtype=torch.float64)
    s, b = torch.ones(1, device=cuda), torch.zeros(1, device=cuda)
    with pytest.raises(NotImplementedError, match="float32"):
        fake_quant_forward(x, s, b, spec)
    with pytest.raises(NotImplementedError, match="float32"):
        fake_quant_backward(x, x, s, b, spec)
    with pytest.raises(NotImplementedError, match="float32"):
        fake_quant_fwdbwd(x, x, s, b, spec=spec)


def _fq_case(cuda, name, shape, seed):
    spec = QuantSpec(**FQ_SPECS[name])
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, device=cuda, generator=g) * 1.5
    c = shape[spec.axis] if spec.per_channel else 1
    s = 0.01 + 0.04 * torch.rand(c, device=cuda, generator=g)
    b = (torch.zeros(c, device=cuda) if spec.symmetric
         else 0.2 * torch.randn(c, device=cuda, generator=g))
    gr = torch.randn(shape, device=cuda, generator=g)
    return spec, x, s, b, gr


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape", [(k, s) for k, v in FQ_SHAPES.items() for s in v])
def test_fake_quant_fwdbwd_matches_split_kernels(cuda, name, shape):
    """The fused kernel (one launch) against the static forward and
    backward kernels on the same inputs: out, dX, dS and dB bit-equal (the
    same grid and partials); out and dX bit-equal to the plain version."""
    from jaxlsq_torch.ops.fake_quant import (LAUNCHES, fake_quant_backward,
                                             fake_quant_forward, fake_quant_fwdbwd)

    spec, x, s, b, gr = _fq_case(cuda, name, shape, sum(shape) + 11)
    kind = "pc" if spec.per_channel else "pt"
    for numel in (None, 4 * x.numel()):
        before = dict(LAUNCHES)
        got = fake_quant_fwdbwd(gr, x, s, b, spec=spec, numel=numel)
        torch.cuda.synchronize()
        assert LAUNCHES[f"fq_fwdbwd_{kind}"] == before[f"fq_fwdbwd_{kind}"] + 1
        assert sum(LAUNCHES.values()) == sum(before.values()) + 1
        want = (fake_quant_forward(x, s, b, spec),
                *fake_quant_backward(gr, x, s, b, spec, numel=numel))
        for a, w in zip(got, want):
            assert torch.equal(a, w)
    cpu = [t.cpu() for t in (gr, x, s, b)]
    rout, rdx, _, _ = fake_quant_fwdbwd(*cpu, spec=spec)
    assert torch.equal(got[0].cpu(), rout) and torch.equal(got[1].cpu(), rdx)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("name,shape", [("act", (64, 512, 4, 4)), ("w_oihw", (128, 64, 1, 1))])
def test_fake_quant_sixteen_bit_on_card_matches_cpu(cuda, name, shape, dtype):
    """16-bit inputs at every fake-quant entry point on the card: widened
    to f32, one kernel launch each, out and dX in the input's dtype and
    bit-equal to the CPU plain path, dS/dB within 1e-4 relative (+1e-5)."""
    from jaxlsq_torch.ops.fake_quant import (LAUNCHES, fake_quant_backward,
                                             fake_quant_backward_traced,
                                             fake_quant_forward,
                                             fake_quant_forward_traced,
                                             fake_quant_fwdbwd)

    spec, x, s, b, gr = _fq_case(cuda, name, shape, sum(shape) + 13)
    dt = getattr(torch, dtype)
    x, gr = x.to(dt), gr.to(dt)
    flags = torch.zeros(2, device=cuda)
    calls = {
        "forward": lambda *a: (fake_quant_forward(a[1], a[2], a[3], spec),),
        "backward": lambda *a: fake_quant_backward(*a[:4], spec),
        "forward_traced": lambda *a: (fake_quant_forward_traced(a[1], a[2], a[3],
                                                                a[4], spec),),
        "backward_traced": lambda *a: fake_quant_backward_traced(*a, spec),
        "fwdbwd": lambda *a: fake_quant_fwdbwd(*a[:4], spec=spec),
    }
    for what, fn in calls.items():
        before = sum(LAUNCHES.values())
        got = fn(gr, x, s, b, flags)
        torch.cuda.synchronize()
        assert sum(LAUNCHES.values()) == before + 1, what
        want = fn(gr.cpu(), x.cpu(), s.cpu(), b.cpu(), flags.cpu())
        for i, (a, w) in enumerate(zip(got, want)):
            if a.shape == x.shape:
                assert a.dtype == dt and torch.equal(a.cpu(), w), (what, i)
            else:
                assert a.dtype == torch.float32
                np.testing.assert_allclose(a.cpu().numpy(), w.numpy(), rtol=1e-4,
                                           atol=1e-5, err_msg=what)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,m", [(8192, 8192, 1), (1024, 1024, 16), (4096, 1024, 130),
                                   (512, 300, 5), (66, 17, 3)])
def test_wo4_lab_kernels_match_plain(cuda, k, n, m):
    """``wo4_bf16`` and ``wo4_native`` against their plain versions within
    1e-4 of max|ref| (f32 K-sums in another order), and ``wo4_native``
    against ``wo4`` on the same int4 values within the same bound."""
    from jaxlsq_torch.lab import int4_kernel_lab as lab

    _, p4, w4, sc, r = lab.lab_weights(k, n, cuda)
    x = torch.from_numpy(r.randn(m, k).astype(np.float32)).to(cuda)
    before = dict(lab.LAUNCHES)
    bf, nat, cur = lab.run_bf16(x, p4), lab.run_native(x, w4, sc), wo_matmul(x, p4)
    torch.cuda.synchronize()
    assert lab.LAUNCHES["wo4_bf16"] == before["wo4_bf16"] + 1
    assert lab.LAUNCHES["wo4_native"] == before["wo4_native"] + 1
    for got, ref in ((bf, lab.run_bf16_plain(x, p4)),
                     (nat, lab.run_native_plain(x, w4, sc)), (nat, cur)):
        tol = 1e-4 * float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol


@pytest.mark.gpu
def test_wo4_lab_kernels_take_odd_k_split_half_and_refuse_it_native(cuda):
    from jaxlsq_torch.lab import int4_kernel_lab as lab

    g = torch.Generator(device=cuda).manual_seed(9)
    k, n = 1023, 520
    w = torch.randn(k, n, device=cuda, generator=g) * 0.05
    spec = QuantSpec.make(4, signed=True, symmetric=True, per_channel=True, axis=1)
    p4 = quantize_weight(w, w.abs().amax(0) / 7, torch.zeros(n, device=cuda), spec,
                         bits=4)
    x = torch.randn(7, k, device=cuda, generator=g)
    ref = lab.run_bf16_plain(x, p4)
    assert float((lab.run_bf16(x, p4) - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    with pytest.raises(ValueError, match="K even"):
        lab.pack_native(torch.zeros(k, n, dtype=torch.int8, device=cuda))


def _lab_weights(k, n, device, seed):
    """Random int4 bytes for both lab layouts (split-half ``PackedWeight``,
    and K-contiguous bytes where K is even) and a (n,) scale."""
    from jaxlsq_torch.serve.pack import PackedWeight

    g = torch.Generator(device=device).manual_seed(seed)
    scale = torch.rand(n, device=device, generator=g) * 1e-2 + 1e-3
    p4 = PackedWeight(
        data=torch.randint(-128, 128, ((k + 1) // 2, n), device=device,
                           generator=g).to(torch.int8),
        scale=scale, zero_point=torch.zeros(n, dtype=torch.int32, device=device),
        bits=4, axis=1, k_axis=0, orig_shape=(k, n))
    w4 = (torch.randint(-128, 128, (k // 2, n), device=device, generator=g).to(torch.int8)
          if k % 2 == 0 else None)
    x = torch.randn(130, k, device=device, generator=g)
    return p4, w4, scale, x


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(8192, 1032), (1023, 520), (66, 17), (4096, 300),
                                 (1024, 8192)])
def test_int4_lab_rows_same_bits_at_every_m(cuda, k, n):
    """``wo4_bf16`` and ``wo4_native`` sum every output in one order
    (128-byte-row slices on the tensor cores, folded in slice order), so a
    row's bits do not depend on M or on the form M picks (M = 1, 8, 16 the
    decode form, its K over a cluster; 128, 130 the tiled form) or on the
    run; one launch a call; within 1e-4 of max|ref| of the plain versions.
    Random bytes (odd K: the last byte row's dead high nibble too), ragged
    column tiles (N = 17, 300, 520, 1032)."""
    from jaxlsq_torch.lab import int4_kernel_lab as lab

    p4, w4, sc, x = _lab_weights(k, n, cuda, k + n)
    kinds = {"wo4_bf16": lambda xx: lab.run_bf16(xx, p4)}
    plain = {"wo4_bf16": lab.run_bf16_plain(x, p4)}
    if w4 is not None:
        kinds["wo4_native"] = lambda xx: lab.run_native(xx, w4, sc)
        plain["wo4_native"] = lab.run_native_plain(x, w4, sc)
    full = {name: fn(x) for name, fn in kinds.items()}
    for m in (1, 8, 16, 128, 130):
        for name, fn in kinds.items():
            before = dict(lab.LAUNCHES)
            out = fn(x[:m])
            torch.cuda.synchronize()
            assert lab.LAUNCHES == {**before, name: before[name] + 1}
            assert torch.equal(out, full[name][:m]), (name, m)
    for name, fn in kinds.items():
        assert torch.equal(fn(x), full[name])
        ref = plain[name]
        assert float((full[name] - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), name


@pytest.mark.gpu
def test_int4_lab_rows_same_bits_across_cluster_sizes(cuda):
    """The decode form splits K over a cluster whose size follows the
    column tiles: at K = 4096 (16 slices) the full N = 34816 (272 tiles of
    128, more than the card holds at once in clusters of two) takes one
    block a tile, its first 1032 columns (9 tiles) a cluster of two; both
    give the same bits in those columns, and so does the tiled form (M =
    128)."""
    from jaxlsq_torch.lab import int4_kernel_lab as lab
    from jaxlsq_torch.serve.pack import PackedWeight

    k, n, part = 4096, 34816, 1032
    p4, w4, sc, x = _lab_weights(k, n, cuda, 7)
    q4 = PackedWeight(p4.data[:, :part].contiguous(), sc[:part].contiguous(),
                      p4.zero_point[:part], 4, 1, 0, (k, part))
    v4 = w4[:, :part].contiguous()
    for m in (1, 16, 128):
        assert torch.equal(lab.run_bf16(x[:m], p4)[:, :part], lab.run_bf16(x[:m], q4)), m
        assert torch.equal(lab.run_native(x[:m], w4, sc)[:, :part],
                           lab.run_native(x[:m], v4, sc[:part])), m


def _optim_state(opt, model):
    return {f"{name}/{k}": v for name, p in model.named_parameters()
            for k, v in opt.state[p].items() if torch.is_tensor(v)}


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["sgd", "adamw"])
def test_captured_step_follows_a_changing_lr(cuda, which):
    """The captured step under an lr that changes before every step, against
    the eager step of the same Tensor-lr optimizer from one state (cuDNN
    deterministic): SGD(momentum 0.9, weight decay 1e-2, fused=True) and
    AdamW(weight decay 1e-2, capturable=True), 5 steps across the observer
    window.  The captured side's schedule writes Python floats into
    ``group['lr']``, the eager side fills its lr tensor; losses, every
    variable and the optimizer state equal."""
    from jaxlsq_torch.models import QuantResNet
    from jaxlsq_torch.parallel import make_train_step

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=2)
        models = [QuantResNet(10, qc, stage_sizes=(1, 1), widths=(16, 32), device=cuda)
                  for _ in range(2)]
        interop.load_qat_variables(models[1], interop.qat_variables(models[0]))
        base = 1e-2 if which == "sgd" else 1e-3

        def make(m):
            lr = torch.tensor(base, device=cuda)
            if which == "sgd":
                return torch.optim.SGD(m.parameters(), lr=lr, momentum=0.9,
                                       weight_decay=1e-2, fused=True)
            return torch.optim.AdamW(m.parameters(), lr=lr, weight_decay=1e-2,
                                     capturable=True)

        opts = [make(m) for m in models]
        eager = make_train_step(models[0], opts[0], jit=False)
        captured = make_train_step(models[1], opts[1], jit=True)
        r = np.random.RandomState(1)
        for i in range(5):
            lr = base * (1.0 - 0.15 * i)
            opts[0].param_groups[0]["lr"].fill_(lr)
            opts[1].param_groups[0]["lr"] = lr
            batch = {"image": torch.from_numpy(r.randn(8, 3, 16, 16).astype(np.float32)).to(cuda),
                     "label": torch.from_numpy(r.randint(0, 10, size=8)).to(cuda)}
            want = eager(batch)["loss"]
            got = captured(batch)["loss"]
            torch.cuda.synchronize()
            assert torch.equal(got, want), (i, float(got), float(want))
            assert torch.is_tensor(opts[1].param_groups[0]["lr"])
            assert float(opts[1].param_groups[0]["lr"]) == float(torch.tensor(lr))
            trees = [interop.qat_variables(m) for m in models]
            for path, v in _leaves(trees[0]):
                np.testing.assert_array_equal(_get(trees[1], path), v,
                                              err_msg=f"step {i} {path}")
            states = [_optim_state(o, m) for o, m in zip(opts, models)]
            assert states[0].keys() == states[1].keys()
            for key, v in states[0].items():
                assert torch.equal(states[1][key], v), (i, key)
        assert len(captured.graphs) == 1
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


@pytest.mark.gpu
def test_captured_step_refuses_stale_hyperparameters(cuda):
    """A captured step never replays a stale hyperparameter: a changed
    momentum raises, a changed lr of an optimizer that reads it from the
    host (SGD without fused=True) raises naming fused=True, and an Adam
    with capturable=False is refused before anything runs."""
    from jaxlsq_torch.models import QuantResNet
    from jaxlsq_torch.parallel import make_train_step

    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=1)
    r = np.random.RandomState(2)
    batch = {"image": torch.from_numpy(r.randn(4, 3, 16, 16).astype(np.float32)).to(cuda),
             "label": torch.from_numpy(r.randint(0, 10, size=4)).to(cuda)}

    def captured(opt_fn):
        m = QuantResNet(10, qc, stage_sizes=(1,), widths=(8,), device=cuda)
        opt = opt_fn(m)
        step = make_train_step(m, opt, jit=True)
        step(batch)
        step(batch)  # the capture
        return step, opt

    step, opt = captured(lambda m: torch.optim.SGD(m.parameters(), lr=1e-2, momentum=0.9,
                                                   fused=True))
    opt.param_groups[0]["lr"] = 5e-3  # read from the device: fine
    step(batch)
    opt.param_groups[0]["momentum"] = 0.5
    with pytest.raises(RuntimeError, match="momentum"):
        step(batch)
    step, opt = captured(lambda m: torch.optim.SGD(m.parameters(), lr=1e-2, momentum=0.9))
    opt.param_groups[0]["lr"] = 5e-3
    with pytest.raises(RuntimeError, match="fused=True"):
        step(batch)
    m = QuantResNet(10, qc, stage_sizes=(1,), widths=(8,), device=cuda)
    with pytest.raises(ValueError, match="capturable=True"):
        make_train_step(m, torch.optim.Adam(m.parameters(), lr=1e-3), jit=True)(batch)


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape", [("w_oihw", (512, 512, 3, 3)),
                                        ("w_kn", (512, 8192)), ("act", (64, 64, 32, 32))])
def test_fake_quant_kernels_are_deterministic(cuda, name, shape):
    """The grid depends on the shape alone: the same input gives the same
    bits on every run (an OIHW weight on axis 0, a (K, N) one on axis 1 and
    a per-tensor activation)."""
    from jaxlsq_torch.ops.fake_quant import fake_quant_backward

    spec = QuantSpec(**FQ_SPECS[name])
    c = shape[spec.axis] if spec.per_channel else 1
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, device=cuda, generator=g) * 0.02
    gr = torch.randn(x.shape, device=cuda, generator=g)
    s, b = torch.full((c,), 2e-4, device=cuda), torch.zeros(c, device=cuda)
    first = fake_quant_backward(gr, x, s, b, spec)
    for _ in range(3):
        again = fake_quant_backward(gr, x, s, b, spec)
        assert all(torch.equal(a, b_) for a, b_ in zip(first, again))


# the per-channel backward's order cases (tests/test_torch_fq_pc_order.py):
# runs at 1, 2, 4 and 8 warps a channel and over a cluster, rows over 1, 2
# and 8 blocks, and the table's two shapes
PC_ORDER_CASES = [("w_oihw", (64, 256, 3, 3)), ("aff_oihw", (16, 1024, 3, 3)),
                  ("w_oihw", (64, 64, 3, 3)), ("aff_oihw", (64, 32, 3, 3)),
                  ("w_oihw", (64, 3, 3, 3)),
                  ("aff_oihw", (5, 3, 1, 1)), ("aff_nchw", (8, 16, 5, 5)),
                  ("w_kn", (512, 10)), ("aff_kn", (33, 300)), ("aff_kn", (128, 8192)),
                  ("w_kn", (256, 512)), ("w_oihw", (512, 512, 3, 3)),
                  ("w_kn", (512, 8192))]
PC_ORDER_SPECS = {**FQ_SPECS,
                  "aff_oihw": dict(quant_min=0, quant_max=255, per_channel=True, axis=0),
                  "aff_kn": dict(quant_min=0, quant_max=127, per_channel=True, axis=1)}


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape", PC_ORDER_CASES)
def test_fake_quant_pc_backward_has_the_emulated_bits(cuda, name, shape):
    """dS/dB of ``fq_bwd_pc`` (train and init mode), ``fq_bwd_pc_traced``
    (the four flag pairs) and ``fq_fwdbwd_pc`` equal the CPU emulation of the
    kernels' order (``tests/_fq_pc_order.py``) bit for bit, on contiguous
    inputs and on 4-byte-aligned ones (the 16-byte loads switched off); the
    order never depends on the load width."""
    import _fq_pc_order as em
    from jaxlsq_torch.ops.fake_quant import (fake_quant_backward,
                                             fake_quant_backward_traced,
                                             fake_quant_fwdbwd)

    spec = QuantSpec(**PC_ORDER_SPECS[name])
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + 17)
    c = shape[spec.axis]
    n = int(np.prod(shape))
    # one buffer, the tensors at element offsets 0 and 1
    xbuf = torch.randn(n + 1, device=cuda, generator=g) * 1.5
    gbuf = torch.randn(n + 1, device=cuda, generator=g)
    s = 0.01 + 0.04 * torch.rand(c, device=cuda, generator=g)
    b = (torch.zeros(c, device=cuda) if spec.symmetric
         else 0.2 * torch.randn(c, device=cuda, generator=g))
    for off in (0, 1):
        x, gr = xbuf[off:off + n].view(shape), gbuf[off:off + n].view(shape)
        cpu = [t.cpu() for t in (gr, x, s, b)]
        for init in (False, True):
            want = em.backward_sums(*cpu, spec, init)
            _, ds, db = fake_quant_backward(gr, x, s, b, spec, init_mode=init)
            assert torch.equal(ds.cpu(), want[0]) and torch.equal(db.cpu(), want[1])
        for ev, ini in ((0, 0), (1, 0), (0, 1), (1, 1)):
            flags = torch.tensor([float(ev), float(ini)], device=cuda)
            want = em.backward_sums(*cpu, spec, bool(ini), ev=ev)
            _, ds, db = fake_quant_backward_traced(gr, x, s, b, flags, spec)
            assert torch.equal(ds.cpu(), want[0]) and torch.equal(db.cpu(), want[1])
        want = em.backward_sums(*cpu, spec)
        _, _, ds, db = fake_quant_fwdbwd(gr, x, s, b, spec=spec)
        assert torch.equal(ds.cpu(), want[0]) and torch.equal(db.cpu(), want[1])


def _one_kernel_a_call(calls, kernel):
    """Each of ``calls`` ({what: (fn, outputs)}) allocates its outputs only
    (no workspace) and is one kernel, named ``kernel...``, on the profiler's
    record.  The profiler on the card now and then loses a stretch of kernel
    records: a record with fewer kernels is taken again, up to five times."""
    import time

    from torch.profiler import ProfilerActivity, profile

    reps = 5
    for what, (fn, n_out) in calls.items():
        fn()
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        fn()
        torch.cuda.synchronize()
        assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == n_out, what
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            if len(kernels) >= reps:
                break
            time.sleep(1.0)
        assert len(kernels) == reps, (what, [e.name for e in kernels])
        assert all(kernel in e.name for e in kernels), (what, kernels[0].name)


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape", [("w_oihw", (512, 512, 3, 3)),
                                        ("w_oihw", (64, 3, 3, 3)),
                                        ("aff_oihw", (16, 1024, 3, 3)),
                                        ("w_kn", (512, 8192)), ("w_kn", (512, 10))])
def test_fake_quant_pc_backward_is_one_kernel(cuda, name, shape):
    """Each per-channel backward call (static, traced, fused) is one kernel
    on the profiler's record and allocates its outputs only (no workspace)."""
    from jaxlsq_torch.ops.fake_quant import (fake_quant_backward,
                                             fake_quant_backward_traced,
                                             fake_quant_fwdbwd)

    spec = QuantSpec(**PC_ORDER_SPECS[name])
    c = shape[spec.axis]
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(shape, device=cuda, generator=g)
    gr = torch.randn(shape, device=cuda, generator=g)
    s, b = torch.full((c,), 0.02, device=cuda), torch.zeros(c, device=cuda)
    flags = torch.zeros(2, device=cuda)
    _one_kernel_a_call(
        {"fq_bwd_pc": (lambda: fake_quant_backward(gr, x, s, b, spec), 3),
         "fq_bwd_pc_traced": (lambda: fake_quant_backward_traced(gr, x, s, b, flags,
                                                                 spec), 3),
         "fq_fwdbwd_pc": (lambda: fake_quant_fwdbwd(gr, x, s, b, spec=spec), 4)},
        "fq_bwd_pc_")


# the per-channel forward's layouts (tests/test_torch_fq_fwd_plan.py): runs
# at inner % 4 == 0 and not, pieces of a run, C = 1, outer > 1; rows at a
# channel a lane and four, partial strips; the table's two shapes; 9 Mi
# elements (256-element pieces)
PC_FWD_CASES = [("w_oihw", (64, 3, 3, 3)), ("w_oihw", (16, 64, 3, 3)),
                ("aff_oihw", (4, 300, 2, 2)), ("aff_oihw", (3, 5000)),
                ("aff_nchw", (2, 1, 4098)), ("aff_nchw", (8, 16, 5, 5)),
                ("aff_nchw", (3, 7, 4, 4)), ("w_kn", (512, 10)), ("aff_kn", (33, 300)),
                ("w_kn", (17, 12)), ("aff_kn", (40, 1)), ("w_oihw", (1,)),
                ("w_oihw", (128, 64, 1, 1)), ("w_oihw", (512, 512, 3, 3)),
                ("w_kn", (512, 8192)), ("w_oihw", (9000, 1000))]


def _pc_fwd_inputs(cuda, name, shape, seed, off=0):
    """x on its channels' round-half points (k + 0.5) s, k within and beyond
    the range, as a view at element ``off`` of a buffer (off = 1: 4-byte
    aligned), and its qparams."""
    spec = QuantSpec(**PC_ORDER_SPECS[name])
    g = torch.Generator(device=cuda).manual_seed(seed)
    n = int(np.prod(shape))
    c = shape[spec.axis]
    s = 0.01 + 0.04 * torch.rand(c, device=cuda, generator=g)
    b = (torch.zeros(c, device=cuda) if spec.symmetric
         else 0.2 * torch.randn(c, device=cuda, generator=g))
    k = torch.randint(-400, 400, (n,), device=cuda, generator=g).float() + 0.5
    inner = int(np.prod(shape[spec.axis + 1:]))
    buf = torch.empty(n + 1, device=cuda)
    buf[off:off + n] = k * s[(torch.arange(n, device=cuda) // inner) % c]
    return spec, buf[off:off + n].view(shape), s, b


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape", PC_FWD_CASES)
def test_fake_quant_pc_forward_matches_plain_at_every_layout(cuda, name, shape):
    """``fq_fwd_pc`` and ``fq_fwd_pc_traced`` (the four flag pairs) bit-equal
    to ``golden_forward(_traced)`` at the runs and rows layouts, on 16-byte
    and 4-byte aligned views of one buffer (offset by one element), on
    round-half points and beyond the range; one launch a call."""
    from jaxlsq_torch.core.golden import golden_forward, golden_forward_traced
    from jaxlsq_torch.ops.fake_quant import (LAUNCHES, fake_quant_forward,
                                             fake_quant_forward_traced)

    for off in (0, 1):
        spec, x, s, b = _pc_fwd_inputs(cuda, name, shape, sum(shape) + 37, off)
        before = dict(LAUNCHES)
        out = fake_quant_forward(x, s, b, spec)
        torch.cuda.synchronize()
        assert LAUNCHES["fq_fwd_pc"] == before["fq_fwd_pc"] + 1
        assert sum(LAUNCHES.values()) == sum(before.values()) + 1
        assert torch.equal(out, golden_forward(x, s, b, spec)), off
        assert torch.equal(out.cpu(), golden_forward(x.cpu(), s.cpu(), b.cpu(), spec)), off
        for ev, ini in ((0, 0), (1, 0), (0, 1), (1, 1)):
            flags = torch.tensor([float(ev), float(ini)], device=cuda)
            got = fake_quant_forward_traced(x, s, b, flags, spec)
            want = golden_forward_traced(x, s, b, spec, flags[0], flags[1])
            assert torch.equal(got, want), (off, ev, ini)


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape", [("w_oihw", (512, 512, 3, 3)),
                                        ("w_oihw", (64, 3, 3, 3)),
                                        ("w_kn", (512, 8192)), ("w_kn", (512, 10))])
def test_fake_quant_pc_forward_is_one_kernel(cuda, name, shape):
    """Each per-channel forward call (static, traced) is one kernel on the
    profiler's record and allocates its output only."""
    from jaxlsq_torch.ops.fake_quant import (fake_quant_forward,
                                             fake_quant_forward_traced)

    spec, x, s, b = _pc_fwd_inputs(cuda, name, shape, 41)
    flags = torch.zeros(2, device=cuda)
    _one_kernel_a_call(
        {"fq_fwd_pc": (lambda: fake_quant_forward(x, s, b, spec), 1),
         "fq_fwd_pc_traced": (lambda: fake_quant_forward_traced(x, s, b, flags, spec), 1)},
        "fq_fwd_pc_")


@pytest.mark.gpu
def test_fake_quant_pc_forward_replays_give_the_eager_bits(cuda):
    """A captured CUDA graph of per-channel forward calls (runs and rows,
    static and traced), replayed on new data and flags, gives the eager
    calls' bits every time."""
    from jaxlsq_torch.ops.fake_quant import (fake_quant_forward,
                                             fake_quant_forward_traced)

    cases = [_pc_fwd_inputs(cuda, name, shape, 43 + k, off) for k, (name, shape, off) in
             enumerate((("w_oihw", (128, 64, 3, 3), 0), ("w_kn", (512, 1536), 0),
                        ("aff_nchw", (8, 16, 5, 5), 1)))]
    flags = torch.zeros(2, device=cuda)

    def run():
        return [f for spec, x, s, b in cases
                for f in (fake_quant_forward(x, s, b, spec),
                          fake_quant_forward_traced(x, s, b, flags, spec))]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    g = torch.Generator(device=cuda).manual_seed(47)
    for i in range(6):
        for _, x, _, _ in cases:
            x.copy_(torch.randn(x.shape, device=cuda, generator=g) * (0.5 + i))
        flags.copy_(torch.tensor([float(i % 2), float(i // 3 % 2)]))
        graph.replay()
        want = run()
        torch.cuda.synchronize()
        for k, (a, w) in enumerate(zip(outs, want)):
            assert torch.equal(a, w), (i, k)


# the per-tensor backward's order cases (tests/test_torch_fq_pt_order.py):
# one tile and less, a block a tile up to 512 tiles, then several tiles a
# block (uneven at 4,198,404), the table's activation and the LM's largest
# (2,048 blocks)
PT_ORDER_SPECS = {**FQ_SPECS, "aff": dict(quant_min=0, quant_max=255)}
PT_ORDER_CASES = [("act", (3,)), ("act", (33, 7, 5)), ("sym", (4097,)),
                  ("act", (64, 512)), ("act", (64, 3, 32, 32)), ("aff", (64, 512, 4, 4)),
                  ("act", (64, 64, 32, 32)), ("sym", (4198404,)), ("aff", (8192, 2048))]


def _pt_case(cuda, name, shape, seed):
    spec = QuantSpec(**PT_ORDER_SPECS[name])
    g = torch.Generator(device=cuda).manual_seed(seed)
    s = 0.01 + 0.04 * torch.rand(1, device=cuda, generator=g)
    b = (torch.zeros(1, device=cuda) if spec.symmetric
         else 0.2 * torch.randn(1, device=cuda, generator=g))
    return spec, s, b, g


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape", PT_ORDER_CASES)
def test_fake_quant_pt_backward_has_the_emulated_bits(cuda, name, shape):
    """dS/dB of ``fq_bwd_pt`` (train and init mode), ``fq_bwd_pt_traced``
    (the four flag pairs) and ``fq_fwdbwd_pt`` equal the CPU emulation of the
    kernels' order (``tests/_fq_pt_order.py``) bit for bit, on 16-byte-aligned
    inputs and at a 1-element offset (the 4-byte loads); the order never
    depends on the load width."""
    import _fq_pt_order as em
    from jaxlsq_torch.ops.fake_quant import (fake_quant_backward,
                                             fake_quant_backward_traced,
                                             fake_quant_fwdbwd)

    spec, s, b, g = _pt_case(cuda, name, shape, sum(shape) + 19)
    n = int(np.prod(shape))
    # one buffer, the tensors at element offsets 0 and 1
    xbuf = torch.randn(n + 1, device=cuda, generator=g) * 1.5
    gbuf = torch.randn(n + 1, device=cuda, generator=g)
    for off in (0, 1):
        x, gr = xbuf[off:off + n].view(shape), gbuf[off:off + n].view(shape)
        cpu = [t.cpu() for t in (gr, x, s, b)]
        want = {(ev, ini): em.backward_sums(*cpu, spec, bool(ini), ev=ev)
                for ev in (0, 1) for ini in (0, 1)}
        for init in (False, True):
            _, ds, db = fake_quant_backward(gr, x, s, b, spec, init_mode=init)
            w = want[0, int(init)]
            assert torch.equal(ds.cpu(), w[0]) and torch.equal(db.cpu(), w[1]), (off, init)
        for (ev, ini), w in want.items():
            flags = torch.tensor([float(ev), float(ini)], device=cuda)
            _, ds, db = fake_quant_backward_traced(gr, x, s, b, flags, spec)
            assert torch.equal(ds.cpu(), w[0]) and torch.equal(db.cpu(), w[1]), (off, ev, ini)
        _, _, ds, db = fake_quant_fwdbwd(gr, x, s, b, spec=spec)
        w = want[0, 0]
        assert torch.equal(ds.cpu(), w[0]) and torch.equal(db.cpu(), w[1]), off


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape", [("act", (64, 64, 32, 32)), ("act", (64, 512)),
                                        ("sym", (4198404,))])
def test_fake_quant_pt_backward_is_one_kernel(cuda, name, shape):
    """Each per-tensor backward call (static, traced, fused) is one kernel
    on the profiler's record (no sum kernel) and allocates its outputs only
    (no workspace, no memset)."""
    from jaxlsq_torch.ops.fake_quant import (fake_quant_backward,
                                             fake_quant_backward_traced,
                                             fake_quant_fwdbwd)

    spec, s, b, g = _pt_case(cuda, name, shape, 5)
    x = torch.randn(shape, device=cuda, generator=g)
    gr = torch.randn(shape, device=cuda, generator=g)
    flags = torch.zeros(2, device=cuda)
    _one_kernel_a_call(
        {"fq_bwd_pt": (lambda: fake_quant_backward(gr, x, s, b, spec), 3),
         "fq_bwd_pt_traced": (lambda: fake_quant_backward_traced(gr, x, s, b, flags,
                                                                 spec), 3),
         "fq_fwdbwd_pt": (lambda: fake_quant_fwdbwd(gr, x, s, b, spec=spec), 4)},
        "fq_bwd_pt_kernel")


def _pt_calls(spec, s, b, flags):
    """Two back-to-back per-tensor backward calls of different sizes (the
    traced kernel at 512 blocks of 4 tiles, the static one at 16 blocks of
    one), then a fused one."""
    from jaxlsq_torch.ops.fake_quant import (fake_quant_backward,
                                             fake_quant_backward_traced,
                                             fake_quant_fwdbwd)

    def run(big, small, gbig, gsmall):
        return (*fake_quant_backward_traced(gbig, big, s, b, flags, spec),
                *fake_quant_backward(gsmall, small, s, b, spec),
                *fake_quant_fwdbwd(gsmall, small, s, b, spec=spec))
    return run


@pytest.mark.gpu
def test_fake_quant_pt_backward_replays_give_the_eager_bits(cuda):
    """A captured CUDA graph of per-tensor backward calls of different sizes
    (each folding in its capture stream's slot), replayed ten times on new
    data, gives the eager calls' bits every time: each call's ticket counter
    is back at 0 for the next."""
    spec, s, b, g = _pt_case(cuda, "act", (1,), 23)
    flags = torch.zeros(2, device=cuda)
    run = _pt_calls(spec, s, b, flags)
    shapes = ((64, 64, 32, 32), (64, 512))
    ins = [torch.randn(shp, device=cuda, generator=g) for _ in (0, 1) for shp in shapes]
    big, small, gbig, gsmall = ins
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(big, small, gbig, gsmall)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run(big, small, gbig, gsmall)
    for i in range(10):
        for t in ins:
            t.copy_(torch.randn(t.shape, device=cuda, generator=g) * (1 + i / 4))
        graph.replay()
        want = run(big, small, gbig, gsmall)
        torch.cuda.synchronize()
        for k, (a, w) in enumerate(zip(outs, want)):
            assert torch.equal(a, w), (i, k)


@pytest.mark.gpu
def test_fake_quant_pt_backward_on_two_streams_at_once(cuda):
    """Calls queued on two streams at once (behind a sleep kernel on each,
    so that they overlap) take a slot a stream and give the bits of the
    same calls on one stream."""
    import importlib

    from jaxlsq_torch import _build

    fq = importlib.import_module("jaxlsq_torch.ops.fake_quant")

    spec, s, b, g = _pt_case(cuda, "sym", (1,), 29)
    flags = torch.zeros(2, device=cuda)
    run = _pt_calls(spec, s, b, flags)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    assert streams[0].cuda_stream != streams[1].cuda_stream
    # run's arguments: the large x, the small x, their incoming gradients
    data = [[torch.randn(shp, device=cuda, generator=g)
             for _ in (0, 1) for shp in ((64, 64, 32, 32), (64, 512))] for _ in range(8)]
    want = [run(*d) for d in data]
    torch.cuda.synchronize()
    got = [[], []]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for k, st in enumerate(streams):
        with torch.cuda.stream(st):
            torch.cuda._sleep(2_000_000)
    for rep in range(4):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                for d in data[k::2]:
                    got[k].append(run(*d))
    torch.cuda.synchronize()
    lib = _build.load_library()
    slots = {fq._pt_slot(lib, s, st.cuda_stream) for st in streams}
    assert len(slots) == 2
    for k in (0, 1):
        for j, outs in enumerate(got[k]):
            for a, w in zip(outs, want[k + 2 * (j % 4)]):
                assert torch.equal(a, w), (k, j)


@pytest.mark.gpu
def test_resnet_train_step_on_card_matches_cpu(cuda):
    """Two B = 8 train steps (the observer window, then LSQ) of a small
    QuantResNet on the card against the same steps on the CPU plain path,
    from the same state (TF32 off for the convs): the losses within 1e-3
    relative, the slack for conv sums taken in another order."""
    from jaxlsq_torch.models import QuantResNet
    from jaxlsq_torch.ops.fake_quant import LAUNCHES
    from jaxlsq_torch.parallel import make_train_step

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=1)
        r = np.random.RandomState(0)
        x = torch.from_numpy(r.randn(8, 3, 16, 16).astype(np.float32))
        y = torch.from_numpy(r.randint(0, 10, size=8))
        losses = {}
        cpu_model = QuantResNet(10, qc, stage_sizes=(1, 1), widths=(16, 32),
                                device="cpu")
        start = interop.qat_variables(cpu_model)
        for dev in ("cuda", "cpu"):
            m = QuantResNet(10, qc, stage_sizes=(1, 1), widths=(16, 32), device=dev)
            interop.load_qat_variables(m, start)
            opt = torch.optim.SGD(m.parameters(), lr=1e-2, momentum=0.9)
            step = make_train_step(m, opt, jit=False)
            before = dict(LAUNCHES)
            batch = {"image": x.to(dev), "label": y.to(dev)}
            losses[dev] = [float(step(batch)["loss"]) for _ in range(2)]
            if dev == "cuda":
                assert all(LAUNCHES[k] > before[k] for k in STATIC_FQ), LAUNCHES
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.gpu
@pytest.mark.parametrize("ev,ini", [(0, 0), (1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("name,shape", [(k, s) for k, v in FQ_SHAPES.items() for s in v])
def test_fake_quant_traced_kernels_match_plain(cuda, name, shape, ev, ini):
    """The traced kernels (modes read from a device flag tensor) against
    their plain versions: forward and dX bit-exact, dS/dB within 1e-5 of the
    sum of |terms|; in train mode dS/dB have the static kernels' bits."""
    from jaxlsq_torch.core.golden import effective_grad_scale
    from jaxlsq_torch.ops.fake_quant import (LAUNCHES, fake_quant_backward,
                                             fake_quant_backward_traced,
                                             fake_quant_forward_traced)

    spec = QuantSpec(**FQ_SPECS[name])
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + 7)
    x = torch.randn(shape, device=cuda, generator=g) * 1.5
    c = shape[spec.axis] if spec.per_channel else 1
    s = 0.01 + 0.04 * torch.rand(c, device=cuda, generator=g)
    b = (torch.zeros(c, device=cuda) if spec.symmetric
         else 0.2 * torch.randn(c, device=cuda, generator=g))
    gr = torch.randn(shape, device=cuda, generator=g)
    flags = torch.tensor([float(ev), float(ini)], device=cuda)
    kind = "pc" if spec.per_channel else "pt"
    before = dict(LAUNCHES)
    out = fake_quant_forward_traced(x, s, b, flags, spec)
    dx, ds, db = fake_quant_backward_traced(gr, x, s, b, flags, spec)
    torch.cuda.synchronize()
    assert LAUNCHES[f"fq_fwd_{kind}_traced"] == before[f"fq_fwd_{kind}_traced"] + 1
    assert LAUNCHES[f"fq_bwd_{kind}_traced"] == before[f"fq_bwd_{kind}_traced"] + 1
    assert out.data_ptr() != x.data_ptr() and dx.data_ptr() != gr.data_ptr()
    cpu = [t.cpu() for t in (gr, x, s, b, flags)]
    ref = fake_quant_forward_traced(cpu[1], cpu[2], cpu[3], cpu[4], spec)
    rdx, rds, rdb = fake_quant_backward_traced(*cpu, spec)
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(dx.cpu(), rdx)
    gs = effective_grad_scale(spec, x.numel(), c)
    sums = _fq_abs_sums(cpu[0], cpu[1], cpu[2], cpu[3], spec, bool(ini), gs)
    for got, want, tot in ((ds, rds, sums[0]), (db, rdb, sums[1])):
        err = (got.cpu().double() - want.double()).abs()
        assert bool((err <= 1e-5 * tot.reshape(err.shape)).all()), (err.max(), tot.max())
        if ev:
            assert not got.any()
    if not ev:
        _, sds, sdb = fake_quant_backward(gr, x, s, b, spec, False, bool(ini))
        assert torch.equal(ds, sds) and torch.equal(db, sdb)


@pytest.mark.gpu
def test_captured_step_matches_eager_step_on_card(cuda):
    """A small QuantResNet's step captured as one CUDA graph
    (``make_train_step(jit=True)``) against the eager step (``jit=False``)
    from one state, cuDNN deterministic: five B = 8 steps across the
    observer window, one graph for all replays, a toggle honoured by a
    replay; losses, every variable and the momentum buffers equal."""
    from jaxlsq_torch.models import QuantResNet, toggles
    from jaxlsq_torch.ops.fake_quant import LAUNCHES
    from jaxlsq_torch.parallel import make_train_step

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=2)
        models = [QuantResNet(10, qc, stage_sizes=(1, 1), widths=(16, 32), device=cuda)
                  for _ in range(2)]
        interop.load_qat_variables(models[1], interop.qat_variables(models[0]))
        opts = [torch.optim.SGD(m.parameters(), lr=1e-2, momentum=0.9) for m in models]
        eager = make_train_step(models[0], opts[0], jit=False)
        captured = make_train_step(models[1], opts[1], jit=True)
        r = np.random.RandomState(0)
        graphs = []
        for i in range(5):
            if i == 4:
                for m in models:
                    toggles.disable_fake_quant_on_act(m)
            batch = {"image": torch.from_numpy(r.randn(8, 3, 16, 16).astype(np.float32)).to(cuda),
                     "label": torch.from_numpy(r.randint(0, 10, size=8)).to(cuda)}
            before = dict(LAUNCHES)
            want = eager(batch)["loss"]
            got = captured(batch)["loss"]
            torch.cuda.synchronize()
            if i == 1:  # the capture: one launch of each traced kernel per quantizer
                n = sum(1 for n_, _ in models[1].named_modules() if n_.endswith("_fq"))
                assert sum(LAUNCHES[k] - before[k] for k in LAUNCHES
                           if k.endswith("_traced")) == 2 * n
            if i >= 1:
                graphs.append(next(iter(captured.graphs.values()))[0])
            assert torch.equal(got, want), (i, float(got), float(want))
            trees = [interop.qat_variables(m) for m in models]
            for path, v in _leaves(trees[0]):
                np.testing.assert_array_equal(_get(trees[1], path), v,
                                              err_msg=f"step {i} {path}")
        assert len(captured.graphs) == 1 and all(g is graphs[0] for g in graphs)
        for p0, p1 in zip(models[0].parameters(), models[1].parameters()):
            assert torch.equal(opts[0].state[p0]["momentum_buffer"],
                               opts[1].state[p1]["momentum_buffer"])
        assert not any(bool(m.fake_quant_enabled) for n_, m in models[1].named_modules()
                       if n_.endswith("act_fq"))
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,hd", [(2, 8, 1000, 64), (1, 2, 60, 32),
                                      (1, 2, 257, 128), (2, 4, 64, 64)])
def test_flash_kernels_match_plain(cuda, b, h, t, hd):
    """The two flash-attention kernels against their plain versions on the
    same inputs: out and lse within 2e-5 of max|ref|, dQ/dK/dV within 1e-4
    of max|ref| (3xTF32 products, f32 sums over t keys in another order)."""
    from jaxlsq_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(t + hd)
    q, k, v, do = (torch.randn(b, h, t, hd, device=cuda, generator=g) for _ in range(4))
    sm = hd ** -0.5
    before = dict(fa.LAUNCHES)
    out, lse = fa.flash_fwd(q, k, v, sm)
    rout, rlse = fa.flash_fwd_plain(q, k, v, sm)
    d = (do * rout).sum(-1)
    dq, dk, dv = fa.flash_bwd(q, k, v, do, rlse, d, sm)
    rdq, rdk, rdv = fa.flash_bwd_plain(q, k, v, do, rlse, d, sm)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd": 1}
    for got, want, tol in ((out, rout, 2e-5), (lse, rlse, 2e-5), (dq, rdq, 1e-4),
                           (dk, rdk, 1e-4), (dv, rdv, 1e-4)):
        assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("t", [4096, 1000])
def test_flash_bwd_is_bit_deterministic(cuda, t):
    """Two runs of the backward kernel on the same inputs give the same bits
    in dq, dk and dv: every block sums its own rows in a fixed order."""
    from jaxlsq_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(t)
    q, k, v, do = (torch.randn(2, 8, t, 64, device=cuda, generator=g) for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, 0.125)
    d = (do * out).sum(-1)
    first = fa.flash_bwd(q, k, v, do, lse, d, 0.125)
    second = fa.flash_bwd(q, k, v, do, lse, d, 0.125)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


def _sass_functions(lib_path, cuobjdump):
    """{mangled kernel name: its SASS} of a built library (``cuobjdump -sass``)."""
    import subprocess

    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}


@pytest.mark.gpu
def test_flash_kernels_use_tensor_cores(cuda):
    """Every instance of both flash kernels runs its products as TF32 HMMA
    (the 3xTF32 tensor-core products), as the built library's SASS shows."""
    import os
    import shutil

    from jaxlsq_torch import _build

    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        pytest.skip("the CUDA toolkit has no cuobjdump")
    funcs = _sass_functions(_build.load_library()._name, cuobjdump)
    for kernel in ("flash_fwd_kernel", "flash_bwd_kernel"):
        found = {k: v for k, v in funcs.items() if kernel in k}
        assert len(found) == len(("hd 32", "hd 64", "hd 128")), (kernel, list(found))
        for name, sass in found.items():
            assert any("HMMA" in ln and "TF32" in ln for ln in sass.splitlines()), name


@pytest.mark.gpu
def test_int4_lab_kernels_use_tensor_cores(cuda):
    """Every instance of the int4 lab's two forms (``csrc/int4_lab.cu``: the
    decode form at 1 and 2 n8 tiles, the tiled form, each for both stagings)
    runs its products as bf16 HMMA, as the built library's SASS shows."""
    import os
    import shutil

    from jaxlsq_torch import _build

    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        pytest.skip("the CUDA toolkit has no cuobjdump")
    funcs = _sass_functions(_build.load_library()._name, cuobjdump)
    found = {k: v for k, v in funcs.items()
             if "lab_decode_kernel" in k or "lab_tiled_kernel" in k}
    assert len(found) == 2 * (2 + 1), list(found)
    for name, sass in found.items():
        assert any("HMMA" in ln and "BF16" in ln for ln in sass.splitlines()), name


@pytest.mark.gpu
def test_flash_attention_autograd_on_card(cuda):
    """``flash_attention`` through autograd: the same gradients as the plain
    attention's autograd, and the same bits on a second run."""
    from jaxlsq_torch.ops.flash_attention import flash_attention, flash_fwd_plain

    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(2, 4, 300, 64, device=cuda, generator=g) for _ in range(4))
    runs = []
    for fn in (flash_attention, flash_attention,
               lambda a, b_, c, s: flash_fwd_plain(a, b_, c, s)[0]):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves, 0.125)
        out.backward(do)
        runs.append([out.detach()] + [x.grad for x in leaves])
    torch.cuda.synchronize()
    for a, b_ in zip(runs[0], runs[1]):
        assert torch.equal(a, b_)
    for a, b_ in zip(runs[0], runs[2]):
        assert float((a - b_).abs().max()) <= 1e-4 * float(b_.abs().max())


@pytest.mark.gpu
def test_flash_kernels_refuse_what_they_cannot_take(cuda):
    from jaxlsq_torch.ops.flash_attention import flash_fwd

    x = torch.randn(1, 2, 64, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd(x, x, x, 0.1)
    x = torch.randn(1, 2, 64, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="f32"):
        flash_fwd(x, x, x, 0.1)


@pytest.mark.gpu
def test_captured_lm_step_matches_eager_step_on_card(cuda):
    """A small QAT LM with 'flash' attention: the step captured as one CUDA
    graph against the eager step from one state, four steps across the
    two-batch observer window: losses and every variable and momentum buffer
    equal; the flash kernels launch depth times a step eagerly, depth times
    in the warm-up and in the capture, never in a replay."""
    from jaxlsq_torch.ops.flash_attention import LAUNCHES as FA
    from jaxlsq_torch.parallel import make_train_step

    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=2)
    models = [QuantTransformerLM(256, 128, 2, 2, qc, max_len=512, pos_embedding="rope",
                                 train_attn_impl="flash", device=cuda, seed=i)
              for i in range(2)]
    interop.load_qat_variables(models[1], interop.qat_variables(models[0]))
    opts = [torch.optim.SGD(m.parameters(), lr=1e-2, momentum=0.9) for m in models]
    eager = make_train_step(models[0], opts[0], jit=False)
    captured = make_train_step(models[1], opts[1], jit=True)
    r = np.random.RandomState(0)
    for i in range(4):
        toks = torch.from_numpy(r.randint(0, 256, size=(2, 301))).to(cuda)
        batch = {"input": toks[:, :-1].contiguous(), "label": toks[:, 1:].contiguous()}
        before = dict(FA)
        want = eager(batch)["loss"]
        mid = dict(FA)
        got = captured(batch)["loss"]
        torch.cuda.synchronize()
        assert all(mid[k] - before[k] == 2 for k in FA), (i, FA)
        assert all(FA[k] - mid[k] == (2 if i < 2 else 0) for k in FA), (i, FA)
        assert torch.equal(got, want), (i, float(got), float(want))
        trees = [interop.qat_variables(m) for m in models]
        for path, v in _leaves(trees[0]):
            np.testing.assert_array_equal(_get(trees[1], path), v, err_msg=f"step {i} {path}")
    for p0, p1 in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(opts[0].state[p0]["momentum_buffer"],
                           opts[1].state[p1]["momentum_buffer"])


# NaN and ±inf: every fake-quant kernel passes a NaN through its clamps as
# the plain version (torch.clamp) and jaxlsq (jnp.clip) do
NAN_CASES = [("act", (33, 7, 5)), ("sym", (64, 512)), ("w_oihw", (64, 3, 3, 3)),
             ("w_oihw", (16, 64, 3, 3)), ("w_kn", (512, 10)), ("w_kn", (33, 300)),
             ("aff_nchw", (8, 16, 5, 5))]


def _nan_inputs(cuda, name, shape, qp, seed):
    """x with NaN, +inf and -inf spread over it (every channel gets some)
    in one buffer one element longer (for the 4-byte-aligned view), and the
    qparams with a NaN scale or shift in one channel (or the one qparam)."""
    spec = QuantSpec(**FQ_SPECS[name])
    g = torch.Generator(device=cuda).manual_seed(seed)
    n = int(np.prod(shape))
    xbuf = torch.randn(n + 1, device=cuda, generator=g) * 1.5
    gbuf = torch.randn(n + 1, device=cuda, generator=g)
    picks = torch.randperm(n + 1, device=cuda, generator=g)[:3 * max(2, n // 40)]
    specials = torch.tensor([float("nan"), float("inf"), -float("inf")], device=cuda)
    xbuf[picks] = specials[torch.arange(picks.numel(), device=cuda) % 3]
    c = shape[spec.axis] if spec.per_channel else 1
    s = 0.01 + 0.04 * torch.rand(c, device=cuda, generator=g)
    b = (torch.zeros(c, device=cuda) if spec.symmetric
         else 0.2 * torch.randn(c, device=cuda, generator=g))
    if qp != "finite":
        (s if qp == "nan_scale" else b)[min(1, c - 1)] = float("nan")
    return spec, xbuf, gbuf, s, b, n


def _same_bits_or_nan(got, want):
    """NaN in the same places, every other element bit-equal."""
    got = got.cpu()
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], want[~nan])


def _sums_close(got, want, tot):
    """NaN and ±inf where the plain sum has them; the finite sums equal or
    within 1e-5 of the sum of |terms| (eval mode's zeros have a NaN term
    sum where a qparam is NaN)."""
    got, want = got.cpu().double(), want.double()
    nan, fin = torch.isnan(want), torch.isfinite(want)
    if not (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~fin & ~nan], want[~fin & ~nan])):
        return False
    err = (got[fin] - want[fin]).abs()
    return bool(((err == 0) | (err <= 1e-5 * tot.reshape(want.shape)[fin])).all())


@pytest.mark.gpu
@pytest.mark.parametrize("qp", ["finite", "nan_scale", "nan_shift"])
@pytest.mark.parametrize("name,shape", NAN_CASES)
def test_fake_quant_kernels_pass_nan_and_inf(cuda, name, shape, qp):
    """Every static (train, eval, init), traced (the four flag pairs) and
    fused fake-quant kernel on x holding NaN, +inf and -inf, with a NaN
    scale or shift, at 16- and 4-byte alignment, against the plain version:
    out and dX NaN in the same places and every other element bit-equal;
    dS/dB NaN and inf where the plain has them, else within 1e-5 of their
    term sums.  fminf/fmaxf alone would turn a NaN x into qmin (a finite
    out, dS on the qmin branch) and a NaN scale into FLT_EPSILON."""
    from jaxlsq_torch.core.golden import effective_grad_scale
    from jaxlsq_torch.ops.fake_quant import (fake_quant_backward,
                                             fake_quant_backward_traced,
                                             fake_quant_forward,
                                             fake_quant_forward_traced,
                                             fake_quant_fwdbwd)

    spec, xbuf, gbuf, s, b, n = _nan_inputs(cuda, name, shape, qp, sum(shape) + 31)
    c = s.numel()
    gs = effective_grad_scale(spec, n, c)
    for off in (0, 1):
        x, gr = xbuf[off:off + n].view(shape), gbuf[off:off + n].view(shape)
        cpu = [t.cpu() for t in (gr, x, s, b)]
        assert bool(torch.isnan(cpu[1]).any() and torch.isinf(cpu[1]).any())
        for eval_mode, init_mode in ((False, False), (True, False), (False, True)):
            out = fake_quant_forward(x, s, b, spec, init_mode)
            got = fake_quant_backward(gr, x, s, b, spec, eval_mode, init_mode)
            ref = fake_quant_forward(*cpu[1:], spec, init_mode)
            want = fake_quant_backward(*cpu, spec, eval_mode, init_mode)
            tot = _fq_abs_sums(*cpu, spec, init_mode, gs)
            what = (off, eval_mode, init_mode)
            assert _same_bits_or_nan(out, ref), what
            assert _same_bits_or_nan(got[0], want[0]), what
            assert _sums_close(got[1], want[1], tot[0]), what
            assert _sums_close(got[2], want[2], tot[1]), what
            if not (eval_mode or init_mode):
                fout, fdx, fds, fdb = fake_quant_fwdbwd(gr, x, s, b, spec=spec)
                assert _same_bits_or_nan(fout, ref) and _same_bits_or_nan(fdx, want[0])
                assert _sums_close(fds, want[1], tot[0]), what
                assert _sums_close(fdb, want[2], tot[1]), what
        for ev, ini in ((0, 0), (1, 0), (0, 1), (1, 1)):
            flags = torch.tensor([float(ev), float(ini)], device=cuda)
            out = fake_quant_forward_traced(x, s, b, flags, spec)
            got = fake_quant_backward_traced(gr, x, s, b, flags, spec)
            ref = fake_quant_forward_traced(*cpu[1:], flags.cpu(), spec)
            want = fake_quant_backward_traced(*cpu, flags.cpu(), spec)
            tot = _fq_abs_sums(*cpu, spec, bool(ini), gs)
            what = (off, ev, ini)
            assert _same_bits_or_nan(out, ref), what
            assert _same_bits_or_nan(got[0], want[0]), what
            assert _sums_close(got[1], want[1], tot[0]), what
            assert _sums_close(got[2], want[2], tot[1]), what
