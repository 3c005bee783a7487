"""jaxlsq_torch's CUDA kernels against their plain PyTorch versions on the
card, and the engine against ``make_generate`` on the card.  Marked ``gpu``:
they skip where there is no CUDA device.  This file imports no jax, so it
also runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: the K-sums of ``wo_matmul`` run in f32 in another order than
the plain matmul (1e-4 of the output's largest magnitude); attention 1e-5.
"""

import numpy as np
import pytest
import torch

from jaxlsq_torch import interop
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.models import QuantTransformerLM, default_qconfig, init_variables
from jaxlsq_torch.serve import DecodeEngine, make_generate
from jaxlsq_torch.serve.attention import (LAUNCHES as ATTN_LAUNCHES,
                                          decode_attention, decode_attention_plain)
from jaxlsq_torch.serve.matmul import LAUNCHES as MM_LAUNCHES
from jaxlsq_torch.serve.matmul import wo_matmul, wo_matmul_plain
from jaxlsq_torch.serve.pack import quantize_weight


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
