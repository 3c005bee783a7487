"""jaxlsq_torch's QAT layers against the JAX package's flax modules, on the
same seeded numpy inputs and the same variables (carried across with
``interop.load_qat_variables``): ``QuantConv`` at stride 1, at stride 2
with SAME padding, and as the 1x1 stride-2 downsample; the QAT
``QuantDense``; and ``BatchNorm`` against flax ``nn.BatchNorm``.  Then the
quantizers' device-held counters and flags through ``state_dict`` and
``interop`` and back.

Each case runs two training calls with ``init_batches=1``: the observer
window (the activation qparams written by the observer, eval-mode
backward), then full LSQ.  It compares the output, the gradients of the
input, the kernel and every quantizer's scale/shift, and the state each
call leaves behind.

Tolerances: the fake-quantized operands are bit-exact on both sides, but
the convolution, matmul and BatchNorm sums run in another order in torch and
in XLA.  Outputs and elementwise gradients are held to 1e-5 of the largest
magnitude of the reference; qparam gradients, which are sums over every
element of such gradients, to 1e-4 relative plus 1e-5 of the largest
magnitude.  The observer state and qparams are exact: the observer reads
the bit-exact fake-quantized input or the raw input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from _torch_port import np_tree
from jaxlsq.models import default_qconfig as jdefault_qconfig
from jaxlsq.models.layers import QuantConv as JQuantConv
from jaxlsq.models.layers import QuantDense as JQuantDense
from jaxlsq_torch import interop
from jaxlsq_torch.models import BatchNorm, QuantConv, QuantDense, default_qconfig
from jaxlsq_torch.models.layers import same_padding

MUTABLE = ["quant_state", "qparams", "batch_stats"]


def _close(got, want, what):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 1e-5 * max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, (what, err, tol)


def _close_sum(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * max(1e-30, float(np.abs(want).max())),
                               err_msg=what)


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


def _grad_of(module, path):
    """The port's gradient at a JAX-tree path of 'params'/'qparams'."""
    mod = module
    for k in path[:-1]:
        if k != "qp":
            mod = getattr(mod, k)
    g = getattr(mod, path[-1]).grad
    return None if g is None else g.detach().numpy()


def _run_layer(jmod, tmod, x_j, to_t, from_t, steps=2, variables=None):
    """Training calls of ``jmod`` and ``tmod`` from the same variables (flax
    ``init``'s unless given); compares outputs, gradients and the state each
    call leaves behind."""
    r = np.random.RandomState(11)
    if variables is None:
        variables = jmod.init(jax.random.key(0), jnp.asarray(x_j), training=False)
    variables = jax.tree.map(np.asarray, variables)
    interop.load_qat_variables(tmod, np_tree(variables))
    params = {k: variables[k] for k in ("params", "qparams") if k in variables}
    state = {k: v for k, v in variables.items() if k not in params}
    tmod.train()
    for step in range(steps):
        def f(p, x):
            out, mut = jmod.apply({**p, **state}, x, training=True, mutable=MUTABLE)
            return out, mut

        jout, vjp, mut = jax.vjp(f, params, jnp.asarray(x_j), has_aux=True)
        cot = r.randn(*jout.shape).astype(np.float32)
        gp, gx = vjp(jnp.asarray(cot))

        for p in tmod.parameters():
            p.grad = None
        xt = torch.from_numpy(to_t(x_j)).requires_grad_(True)
        tout = tmod(xt)
        tout.backward(torch.from_numpy(to_t(cot)))
        _close(from_t(tout.detach().numpy()), jout, f"step {step} output")
        _close(from_t(xt.grad.numpy()), gx, f"step {step} dx")
        for col in gp:
            for path, want in _leaves(gp[col]):
                got = _grad_of(tmod, path)
                if got is None:  # no gradient reached it: JAX's is zero
                    assert not want.any(), path
                    continue
                if path[-1] == "kernel" and got.ndim == 4:
                    got = got.transpose(2, 3, 1, 0)  # OIHW -> HWIO
                check = _close_sum if col == "qparams" else _close
                check(got, want, f"step {step} d{'/'.join(path)}")
        # the state the call left behind
        params = {"params": params["params"], **({"qparams": mut["qparams"]}
                                                  if "qparams" in mut else {})}
        state = {k: mut[k] for k in state}
        mine = interop.qat_variables(tmod)
        for col, tree in {**params, **state}.items():
            for path, want in _leaves(np_tree(dict(tree))):
                got = _get(mine[col], path)  # HWIO kernels, as JAX's
                if col == "batch_stats":
                    _close(got, want, f"step {step} {col}/{'/'.join(path)}")
                else:
                    np.testing.assert_array_equal(got, want, err_msg=f"{col} {path}")
        x_j = (x_j * 1.1 + 0.05).astype(np.float32)


def _nhwc_to_nchw(a):
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2))


def _nchw_to_nhwc(a):
    return a.transpose(0, 2, 3, 1)


@pytest.mark.parametrize("cin,cout,k,stride,hw,bias", [
    (3, 8, 3, 1, 8, False),    # the stem: stride 1, SAME pads (1, 1)
    (8, 16, 3, 2, 8, False),   # a stage's first conv1: SAME pads (0, 1)
    (8, 16, 3, 2, 7, True),    # odd size at stride 2: SAME pads (1, 1)
    (8, 16, 1, 2, 8, False),   # the 1x1 stride-2 downsample: no padding
])
def test_quant_conv_matches_flax(cin, cout, k, stride, hw, bias):
    jqc = jdefault_qconfig(8, 8, per_channel_weights=True, init_batches=1)
    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=1)
    jmod = JQuantConv(cout, (k, k), jqc, strides=stride, use_bias=bias)
    tmod = QuantConv(cin, cout, (k, k), qc, strides=stride, use_bias=bias,
                     device="cpu")
    x = np.random.RandomState(hw + k).randn(4, hw, hw, cin).astype(np.float32)
    _run_layer(jmod, tmod, x, _nhwc_to_nchw, _nchw_to_nhwc)


def test_same_padding_is_xla_rule():
    assert same_padding(32, 3, 2) == (0, 1)
    assert same_padding(7, 3, 2) == (1, 1)
    assert same_padding(32, 3, 1) == (1, 1)
    assert same_padding(32, 1, 2) == (0, 0)
    for size in range(1, 12):
        for k in (1, 2, 3, 5):
            for s in (1, 2, 3):
                pads = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")
                assert same_padding(size, k, s) == tuple(pads[0]), (size, k, s)


@pytest.mark.parametrize("per_channel", [False, True])
def test_quant_dense_qat_matches_flax(per_channel):
    jqc = jdefault_qconfig(4, 8, per_channel_weights=per_channel, init_batches=1)
    qc = default_qconfig(4, 8, per_channel_weights=per_channel, init_batches=1)
    jmod = JQuantDense(12, jqc)
    tmod = QuantDense(20, 12, qc, device="cpu")
    x = np.random.RandomState(5).randn(6, 20).astype(np.float32)
    _run_layer(jmod, tmod, x, lambda a: a, lambda a: a)


class _FlaxBN(fnn.Module):
    @fnn.compact
    def __call__(self, x, *, training=False):
        return fnn.BatchNorm(use_running_average=not training, name="bn")(x)


class _TorchBN(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.bn = BatchNorm(c, device="cpu")

    def forward(self, x):
        return self.bn(x)


@pytest.mark.parametrize("shape", [(4, 5, 5, 6), (8, 6)])
def test_batchnorm_matches_flax(shape):
    """Training (batch statistics, the 0.99 running average of the biased
    variance) and eval (running statistics) against flax nn.BatchNorm."""
    nhwc = len(shape) == 4
    to_t = _nhwc_to_nchw if nhwc else (lambda a: a)
    from_t = _nchw_to_nhwc if nhwc else (lambda a: a)
    x = (np.random.RandomState(6).randn(*shape) * 2 + 0.5).astype(np.float32)
    jmod, tmod = _FlaxBN(), _TorchBN(shape[-1])
    variables = jmod.init(jax.random.key(0), jnp.asarray(x))
    variables = {"params": {"bn": {"scale": np.linspace(0.5, 1.5, shape[-1], dtype=np.float32),
                                   "bias": np.linspace(-1, 1, shape[-1], dtype=np.float32)}},
                 "batch_stats": jax.tree.map(np.asarray, variables["batch_stats"])}
    _run_layer(jmod, tmod, x, to_t, from_t, steps=3, variables=variables)
    # eval: the running statistics
    tmod.eval()
    want = jmod.apply(interop.qat_variables(tmod), jnp.asarray(x), training=False)
    with torch.no_grad():
        got = tmod(torch.from_numpy(to_t(x))).numpy()
    _close(from_t(got), want, "eval output")
    np.testing.assert_array_equal(variables["batch_stats"]["bn"]["var"],
                                  np.ones(shape[-1], np.float32))


@pytest.mark.parametrize("traced", [False, True], ids=["eager", "traced"])
def test_quant_state_round_trips_in_place(traced):
    """The counters, flags and observer count are buffers of the JAX
    package's types (int32, bool, int32): after three training calls (the
    window's end) in either regime, ``state_dict`` and ``interop`` carry
    them to a fresh layer exactly, each load writes every buffer in place
    (a captured graph holds their addresses), and the eager regime's host
    mirror follows the load."""
    jqc = jdefault_qconfig(8, 8, per_channel_weights=True, init_batches=2)
    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=2)
    x = np.random.RandomState(5).randn(6, 20).astype(np.float32)
    variables = jax.tree.map(np.asarray, JQuantDense(12, jqc).init(
        jax.random.key(0), jnp.asarray(x), training=False))
    src = QuantDense(20, 12, qc, device="cpu")
    interop.load_qat_variables(src, np_tree(variables))
    for m in (src.act_fq, src.weight_fq):
        m.traced = traced
    src.train()
    for _ in range(3):
        src(torch.from_numpy(x))
    for m in (src.act_fq, src.weight_fq):
        assert {m.current_batch.dtype, m.n_batches.dtype, m.obs_seen.dtype} == {torch.int32}
        assert {m.fake_quant_enabled.dtype, m.observer_enabled.dtype,
                m.learning_enabled.dtype} == {torch.bool}
    assert int(src.act_fq.current_batch) == 3 and not bool(src.act_fq.observer_enabled)
    tree = interop.qat_variables(src)
    for path, want in _leaves(np_tree(dict(variables["quant_state"]))):
        assert _get(tree["quant_state"], path).dtype == want.dtype, path

    for load in ("state_dict", "interop"):
        dst = QuantDense(20, 12, qc, device="cpu")
        dst.act_fq.host_state()  # a filled mirror, which the load must refresh
        ptrs = {k: v.data_ptr() for k, v in dst.state_dict().items()}
        if load == "state_dict":
            dst.load_state_dict(src.state_dict())
        else:
            interop.load_qat_variables(dst, tree)
        assert {k: v.data_ptr() for k, v in dst.state_dict().items()} == ptrs, load
        got = interop.qat_variables(dst)
        for path, want in _leaves(tree):
            np.testing.assert_array_equal(_get(got, path), want, err_msg=f"{load} {path}")
        for a, b in ((src.act_fq, dst.act_fq), (src.weight_fq, dst.weight_fq)):
            assert b.host_state() == a.host_state(), load
