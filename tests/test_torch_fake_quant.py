"""jaxlsq_torch's fake-quant plain path and autograd ``fake_quant`` against
the JAX package: ``jaxlsq.core.golden``, the Pallas kernels run in interpret
mode, and ``jax.vjp`` of ``jaxlsq.ops.functional.fake_quant``, on the same
seeded numpy inputs.

Tolerances: the forward and dX are bit-exact (every step is one rounded f32
operation in the same order on both sides).  dS and dB are sums, taken in
another order by torch and XLA: within 1e-5 relative to the sum of the
magnitudes of their terms (the scale of a summation-order difference).
Against the interpreted Pallas kernel they are held to the bound the JAX
package holds that kernel to its own golden (rtol 2e-5, atol 1e-6,
tests/test_pallas_kernels.py): its terms differ from golden's in the last
bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.core import golden as jgolden
from jaxlsq.core.spec import QuantSpec as JSpec
from jaxlsq.ops import functional as jfunctional
from jaxlsq.ops import pallas_kernels as pk
from jaxlsq_torch.core import golden as tgolden
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.ops import fake_quant, fake_quant_backward, fake_quant_forward, lsq

SPEC_KW = {
    "affine": dict(quant_min=0, quant_max=127, type_min=0, type_max=255),
    "symmetric": dict(quant_min=-63, quant_max=63, type_min=-128, type_max=127,
                      symmetric=True),
    "affine_pc_oihw": dict(quant_min=0, quant_max=255, per_channel=True, axis=0),
    "symmetric_pc_oihw": dict(quant_min=-127, quant_max=127, symmetric=True,
                              per_channel=True, axis=0),
    "symmetric_pc_kn": dict(quant_min=-63, quant_max=63, symmetric=True,
                            per_channel=True, axis=1),
    "affine_pc_kn": dict(quant_min=0, quant_max=127, per_channel=True, axis=1),
}
SHAPES = {False: [(3,), (33, 7, 5), (4, 8, 6, 6)],
          "oihw": [(16, 8, 3, 3), (5, 3, 1, 1)],
          "kn": [(33, 20), (512, 10)]}
MODES = [(False, False), (True, False), (False, True)]


def _cases():
    for name, kw in SPEC_KW.items():
        key = ("oihw" if name.endswith("oihw") else "kn") if kw.get("per_channel") else False
        for shape in SHAPES[key]:
            yield name, shape


def _inputs(kw, shape, seed=0):
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * 1.5).astype(np.float32)
    c = shape[kw["axis"]] if kw.get("per_channel") else 1
    scale = (0.02 + 0.05 * r.rand(c)).astype(np.float32)
    shift = (np.zeros(c) if kw.get("symmetric") else 0.2 * r.randn(c)).astype(np.float32)
    g = r.randn(*shape).astype(np.float32)
    return x, scale, shift, g


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _abs_sums(g, x, scale, shift, kw, init_mode=False, numel=None):
    """Per qparam, gs times the sum of |term| of dS and of dB, in f64."""
    axis = kw.get("axis", 1) if kw.get("per_channel") else None
    shape = [1] * x.ndim
    if axis is not None:
        shape[axis] = -1
    s = np.maximum(np.abs(scale.astype(np.float64)), 2.0 ** -23).reshape(shape)
    zp = np.round(np.clip(-shift.reshape(shape) / s, kw.get("type_min", kw["quant_min"]),
                          kw.get("type_max", kw["quant_max"])))
    qmin, qmax = kw["quant_min"], kw["quant_max"]
    xq = np.clip(x / s + zp, qmin, qmax)
    mask = (qmin < xq) & (xq < qmax)
    xfq = (np.round(xq) - zp) * s
    geff = 2 * (xfq - x) if init_mode else g.astype(np.float64)
    ds = np.where(mask, geff * (xfq - x) / s,
                  np.where(xq <= qmin, geff * (qmin - zp), geff * (qmax - zp)))
    db = np.where(mask, 0.0, geff)
    red = tuple(a for a in range(x.ndim) if a != axis)
    c = x.shape[axis] if axis is not None else 1
    gs = tgolden.effective_grad_scale(QuantSpec(**kw), numel or x.size, c)
    return (np.abs(ds).sum(axis=red) * abs(gs), np.abs(db).sum(axis=red) * abs(gs))


def _close_sums(got, want, abs_sum):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-5 * abs_sum.reshape(want.shape)), (
        got, want, abs_sum)


@pytest.mark.parametrize("name,shape", list(_cases()))
def test_forward_bit_exact(name, shape):
    kw = SPEC_KW[name]
    x, scale, shift, _ = _inputs(kw, shape)
    ours = fake_quant_forward(*_t(x, scale, shift), QuantSpec(**kw)).numpy()
    jspec = JSpec(**kw)
    np.testing.assert_array_equal(
        ours, np.asarray(jgolden.golden_forward(*_j(x, scale, shift), jspec)))
    np.testing.assert_array_equal(
        ours, np.asarray(pk.pallas_forward(*_j(x, scale, shift), spec=jspec,
                                           interpret=True)))
    # init mode is the identity, with no copy
    xt = torch.from_numpy(x)
    assert fake_quant_forward(xt, *_t(scale, shift), QuantSpec(**kw),
                              init_mode=True) is xt


@pytest.mark.parametrize("eval_mode,init_mode", MODES)
@pytest.mark.parametrize("name,shape", list(_cases()))
def test_backward_matches_golden_and_pallas(name, shape, eval_mode, init_mode):
    kw = SPEC_KW[name]
    x, scale, shift, g = _inputs(kw, shape, seed=1)
    dx, ds, db = fake_quant_backward(*_t(g, x, scale, shift), QuantSpec(**kw),
                                     eval_mode=eval_mode, init_mode=init_mode)
    jspec = JSpec(**kw)
    refs = [jgolden.golden_backward(*_j(g, x, scale, shift), jspec,
                                    eval_mode=eval_mode, init_mode=init_mode),
            pk.pallas_backward(*_j(g, x, scale, shift), spec=jspec,
                               eval_mode=eval_mode, init_mode=init_mode,
                               interpret=True)]
    sums = _abs_sums(g, x, scale, shift, kw, init_mode)
    (gdx, gds, gdb), (pdx, pds, pdb) = refs
    np.testing.assert_array_equal(dx.numpy(), np.asarray(gdx))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(pdx))
    _close_sums(ds.numpy(), gds, sums[0])
    _close_sums(db.numpy(), gdb, sums[1])
    np.testing.assert_allclose(ds.numpy(), np.asarray(pds), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(db.numpy(), np.asarray(pdb), rtol=2e-5, atol=1e-6)
    if eval_mode:
        assert not ds.any() and not db.any()
    if kw.get("symmetric"):
        assert not db.any()


@pytest.mark.parametrize("kw_over", [dict(use_grad_scaling=False),
                                     dict(grad_scaler=0.5),
                                     dict(use_grad_scaling=False, grad_scaler=3.0)])
@pytest.mark.parametrize("name", ["affine", "symmetric_pc_oihw"])
@pytest.mark.parametrize("numel", [None, 10_000])
def test_grad_scale_options(name, kw_over, numel):
    kw = {**SPEC_KW[name], **kw_over}
    shape = (16, 8, 3, 3) if kw.get("per_channel") else (33, 7, 5)
    x, scale, shift, g = _inputs(kw, shape, seed=2)
    spec, jspec = QuantSpec(**kw), JSpec(**kw)
    c = shape[0] if kw.get("per_channel") else 1
    n = numel if numel is not None else x.size
    assert tgolden.effective_grad_scale(spec, n, c) == jgolden.effective_grad_scale(
        jspec, n, c)
    _, ds, db = fake_quant_backward(*_t(g, x, scale, shift), spec, numel=numel)
    _, rds, rdb = jgolden.golden_backward(*_j(g, x, scale, shift), jspec, numel=numel)
    sums = _abs_sums(g, x, scale, shift, kw, numel=numel)
    _close_sums(ds.numpy(), rds, sums[0])
    _close_sums(db.numpy(), rdb, sums[1])


@pytest.mark.parametrize("eval_mode,init_mode", MODES)
@pytest.mark.parametrize("name,shape", [("affine", (33, 7, 5)),
                                        ("symmetric_pc_oihw", (16, 8, 3, 3)),
                                        ("affine_pc_kn", (33, 20))])
def test_autograd_matches_jax_vjp(name, shape, eval_mode, init_mode):
    kw = SPEC_KW[name]
    x, scale, shift, g = _inputs(kw, shape, seed=3)
    xt, st, bt = _t(x, scale, shift)
    for t in (xt, st, bt):
        t.requires_grad_(True)
    out = fake_quant(xt, st, bt, QuantSpec(**kw), eval_mode=eval_mode,
                     init_mode=init_mode)
    out.backward(torch.from_numpy(g))

    def f(a, s, b):
        return jfunctional.fake_quant(a, s, b, JSpec(**kw), eval_mode=eval_mode,
                                      init_mode=init_mode)

    jout, vjp = jax.vjp(f, *_j(x, scale, shift))
    jdx, jds, jdb = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jdx))
    sums = _abs_sums(g, x, scale, shift, kw, init_mode)
    if eval_mode:
        sums = (0 * sums[0], 0 * sums[1])
    _close_sums(st.grad.numpy(), jds, sums[0])
    _close_sums(bt.grad.numpy(), jdb, sums[1])


def test_size_one_qparams_broadcast_per_channel():
    """A (1,) scale/shift is broadcast to C before the autograd Function, so
    the gradient is summed back to the (1,) parameter, as in the JAX package."""
    kw = SPEC_KW["affine_pc_kn"]
    x, _, _, g = _inputs(kw, (33, 20), seed=4)
    s1, b1 = np.array([0.04], np.float32), np.array([0.1], np.float32)
    xt, st, bt = _t(x, s1, b1)
    st.requires_grad_(True)
    bt.requires_grad_(True)
    out = fake_quant(xt, st, bt, QuantSpec(**kw))
    out.backward(torch.from_numpy(g))
    jout, vjp = jax.vjp(lambda s, b: jfunctional.fake_quant(
        jnp.asarray(x), s, b, JSpec(**kw)), *_j(s1, b1))
    jds, jdb = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    assert st.grad.shape == (1,) and bt.grad.shape == (1,)
    sums = _abs_sums(g, x, np.repeat(s1, 20), np.repeat(b1, 20), kw)
    _close_sums(st.grad.numpy(), jds, sums[0].sum(keepdims=True))
    _close_sums(bt.grad.numpy(), jdb, sums[1].sum(keepdims=True))


def test_lsq_defaults_match_jax():
    x, scale, shift, g = _inputs({}, (4, 8, 6, 6), seed=5)
    xt, st, bt = _t(x * 20 + 60, scale * 10, shift)
    for t in (xt, st, bt):
        t.requires_grad_(True)
    out = lsq(xt, st, bt)
    out.backward(torch.from_numpy(g))
    jout, vjp = jax.vjp(jfunctional.lsq, *_j(x * 20 + 60, scale * 10, shift))
    jdx, jds, jdb = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jdx))
    sums = _abs_sums(g, x * 20 + 60, scale * 10, shift,
                     dict(quant_min=0, quant_max=255))
    _close_sums(st.grad.numpy(), jds, sums[0])
    _close_sums(bt.grad.numpy(), jdb, sums[1])


def test_error_paths():
    spec = QuantSpec(**SPEC_KW["affine"])
    x = torch.randn(4, 5)
    with pytest.raises(ValueError, match="1-D"):
        fake_quant(x, torch.ones(1, 1), torch.zeros(1), spec)
    with pytest.raises(ValueError, match="1-D"):
        fake_quant(x, torch.ones(()), torch.zeros(1), spec)
    pc = QuantSpec(**SPEC_KW["affine_pc_kn"])
    with pytest.raises(ValueError, match="size 5"):
        fake_quant(x, torch.ones(3), torch.zeros(3), pc)
    with pytest.raises(ValueError, match="cover 0"):
        QuantSpec(quant_min=1, quant_max=10, symmetric=True)
    meta = torch.empty(4, 5, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fake_quant_forward(meta, torch.ones(1, device="meta"),
                           torch.zeros(1, device="meta"), spec)
    with pytest.raises(ValueError, match="unsupported device"):
        fake_quant_backward(meta, meta, torch.ones(1, device="meta"),
                            torch.zeros(1, device="meta"), spec)


def test_no_double_backward():
    """The port's backward is once_differentiable (the JAX package's golden
    path allows a second derivative; ROADMAP queue C)."""
    spec = QuantSpec(**SPEC_KW["affine"])
    x = torch.randn(6, 7, requires_grad=True)
    s = torch.full((1,), 0.05, requires_grad=True)
    b = torch.zeros(1, requires_grad=True)
    (gx,) = torch.autograd.grad(fake_quant(x, s, b, spec).sum(), x, create_graph=True)
    with pytest.raises(RuntimeError):
        gx.sum().backward()
