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
* Each plain version (forward, dK/dV, dQ) against autograd of plain
  attention, in f64, within 1e-12: each is the yardstick its kernel is held
  to on the card.
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
    """Forward, dK/dV and dQ, each written from the formulas, against
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
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, d, sm)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, d, sm)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).detach().numpy(),
                               rtol=0, atol=1e-12)
    for got, want in ((out, ref.detach()), (dq, leaves[0].grad), (dk, leaves[1].grad),
                      (dv, leaves[2].grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


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
