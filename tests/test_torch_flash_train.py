"""The port's training-path attention against the JAX package's, on the same
seeded numpy inputs (``jaxlsq_torch.ops.flash_attention`` and the routing in
``jaxlsq_torch.models.zoo``).

* ``_flash_train_attention``: the port's causal flash attention (on the CPU
  its kernels' plain versions, through the ``autograd.Function``) against
  jaxlsq's, which runs the upstream Pallas kernel in TPU-interpret mode
  here, forward and ``jax.vjp``: at (B, H, t, hd) = (1, 2, 128, 32), at
  t = 60 (jaxlsq pads to its 128-row blocks, the port masks the tail) and
  with one kv head (GQA, kv heads repeated before the call on both sides).
  Outputs within 2e-5, gradients within 5e-4 · max(1, max|ref|) (the
  kernel's tiled online softmax against one softmax, f32).
* Each plain version (forward, backward) against autograd of plain
  attention, in f64, within 1e-12: each is the yardstick its kernel is held
  to on the card.
* The kernels' numeric design: a torch emulation of their 3xTF32 products
  (each f32 operand split into a TF32 big part, rounded to nearest on the
  low 13 mantissa bits, and the remainder truncated to TF32; small.big +
  big.small, then + big.big) through the whole forward and backward at
  head_dim 32, 64 and 128 and a ragged t, within a tenth of the card's gates
  (out and lse 2e-6, dQ/dK/dV 1e-5 of max|ref|) of the f32 plain versions,
  where one TF32 pass misses the gates themselves.  It does not show the
  tensor cores' own accumulation (it rounds toward zero); only the card
  does.
* ``_banded_train_attention`` (the 'flash' setting under a window shorter
  than t) against jaxlsq's at the four (t, window, kvh) cases of
  tests/test_flash_train.py, output and gradients within 2e-5 (both are
  plain einsums in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.models.zoo import _banded_train_attention as j_banded
from jaxlsq.models.zoo import _flash_train_attention as j_flash
from jaxlsq_torch.ops import flash_attention as fa
from jaxlsq_torch.models.zoo import _banded_train_attention, _flash_train_attention

HD = 32


def _inputs(seed, b, h, kvh, t, hd=HD):
    r = np.random.RandomState(seed)
    q = r.randn(b, h, t, hd).astype(np.float32)
    k, v = (r.randn(b, kvh, t, hd).astype(np.float32) for _ in range(2))
    do = r.randn(b, h, t, hd).astype(np.float32)
    return q, k, v, do


def _jax_vjp(fn, q, k, v, do):
    """jaxlsq's output and gradients, as one jitted program (one compile)."""
    def run(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out,) + vjp(do)

    return [np.asarray(x) for x in jax.jit(run)(*(jnp.asarray(a) for a in (q, k, v, do)))]


def _port(fn, q, k, v, do):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*leaves)
    out.backward(torch.from_numpy(do))
    return [out.detach().numpy()] + [x.grad.numpy() for x in leaves]


def _assert_close(got, want, out_tol, grad_tol):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=out_tol)
    for name, g, w in zip("qkv", got[1:], want[1:]):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=grad_tol * scale,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("t,kvh", [(128, 2), (60, 2), (128, 1)],
                         ids=["t128", "t60_padded_tail", "gqa_kvh1"])
def test_flash_matches_jax_interpret_kernel(t, kvh):
    q, k, v, do = _inputs(t + kvh, 1, 2, kvh, t)
    want = _jax_vjp(lambda a, b, c: j_flash(a, b, c, HD), q, k, v, do)
    got = _port(_flash_train_attention, q, k, v, do)
    _assert_close(got, want, 2e-5, 5e-4)


@pytest.mark.parametrize("t,hd", [(60, 32), (130, 48)])
def test_plain_versions_match_autograd(t, hd):
    """Forward and backward, each written from the formulas, against
    autograd of plain softmax attention (f64; any head_dim on the CPU)."""
    r = np.random.RandomState(t)
    q, k, v, do = (torch.from_numpy(r.randn(2, 3, t, hd)) for _ in range(4))
    sm = hd ** -0.5
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    s = torch.matmul(leaves[0], leaves[1].transpose(-1, -2)) * sm
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -torch.inf)
    ref = torch.matmul(torch.softmax(s, -1), leaves[2])
    ref.backward(do)
    out, lse = fa.flash_fwd(q, k, v, sm)
    d = (do * out).sum(-1)
    dq, dk, dv = fa.flash_bwd(q, k, v, do, lse, d, sm)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).detach().numpy(),
                               rtol=0, atol=1e-12)
    for got, want in ((out, ref.detach()), (dq, leaves[0].grad), (dk, leaves[1].grad),
                      (dv, leaves[2].grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


def _tf32(x):
    """Round f32 to TF32 (10 mantissa bits): to nearest, ties away from zero,
    on the low 13 bits, as ``cvt.rna.tf32.f32``."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x):
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """The kernels' split (``split_tf32`` in csrc/flash_attention.cu) and
    their order of the three products."""
    ab, bb = _tf32(a), _tf32(b)
    a_small, b_small = _tf32_truncated(a - ab), _tf32_truncated(b - bb)
    return (torch.matmul(a_small, bb) + torch.matmul(ab, b_small)) + torch.matmul(ab, bb)


def _mm_tf32(a, b):
    return torch.matmul(_tf32(a), _tf32(b))


def _attention_with(mm, q, k, v, do, sm):
    """(out, lse, dq, dk, dv) as the kernels compute them, every product
    through ``mm``; softmax, masks and sums in f32."""
    t = q.shape[2]
    s = mm(q, k.transpose(-1, -2)) * sm
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -torch.inf)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    out = mm(p, v)
    ds = p * (mm(do, v.transpose(-1, -2)) - (do * out).sum(-1)[..., None])
    return (out, lse, mm(ds, k) * sm, mm(ds.transpose(-1, -2), q) * sm,
            mm(p.transpose(-1, -2), do))


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("t", [60, 1000])
def test_3xtf32_products_sit_inside_the_card_gates(hd, t):
    r = np.random.RandomState(hd + t)
    q, k, v, do = (torch.from_numpy(r.randn(1, 2, t, hd).astype(np.float32))
                   for _ in range(4))
    sm = hd ** -0.5
    out, lse = fa.flash_fwd_plain(q, k, v, sm)
    d = (do * out).sum(-1)
    ref = (out, lse) + fa.flash_bwd_plain(q, k, v, do, lse, d, sm)
    gates = (2e-5, 2e-5, 1e-4, 1e-4, 1e-4)  # chip_smoke phase 2: out, lse, dq, dk, dv

    def rel_errs(mm):
        return [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(_attention_with(mm, q, k, v, do, sm), ref)]

    three = rel_errs(_mm_3xtf32)
    assert all(e <= g / 10 for e, g in zip(three, gates)), three
    one = rel_errs(_mm_tf32)
    assert one[0] > gates[0] and max(one[2:]) > gates[2], one


def test_flash_attention_refuses_unrepeated_kv():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="repeat the kv heads"):
        fa.flash_attention(q, torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16), 0.25)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_fwd(q.to("meta"), q.to("meta"), q.to("meta"), 0.25)


@pytest.mark.parametrize("t,window,kvh", [
    (128, 32, 2),      # aligned blocks, MHA
    (128, 32, 1),      # aligned blocks, GQA
    (100, 24, 2),      # t not a multiple of the window (padding path)
    (128, 1, 2),       # degenerate window: each query sees only itself
])
def test_banded_matches_jax(t, window, kvh):
    q, k, v, do = _inputs(window + t, 2, 2, kvh, t)
    want = _jax_vjp(lambda a, b, c: j_banded(a, b, c, HD, window), q, k, v, do)
    got = _port(lambda a, b, c: _banded_train_attention(a, b, c, window), q, k, v, do)
    _assert_close(got, want, 2e-5, 2e-5)
