"""jaxlsq_torch's int4 kernel lab (``jaxlsq_torch.lab.int4_kernel_lab``)
against the JAX package's lab (``examples/_int4_kernel_lab.py``, imported by
path), whose two Pallas kernels run under ``pltpu.force_tpu_interpret_mode``.

The lab's own seeded weights (K = 512, N = 256) are drawn as the JAX lab
draws them and carried across field by field (the split-half
``PackedWeight``) and through ``pack_native`` (the ``jnp.int4`` values);
``run_bf16_plain``/``run_native_plain`` (and ``run_bf16``/``run_native``,
which take them on a CPU tensor) agree with the interpreted kernels within
1e-5 of the output's largest magnitude at M in {1, 4} (f32 sums in another
order).  The port's own draw (``lab_weights``) gives the same bytes.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from _torch_port import np_tree
from jaxlsq import QuantSpec as JSpec
from jaxlsq.serve import quantize_weight as jquantize_weight
from jaxlsq_torch.lab import int4_kernel_lab as lab
from jaxlsq_torch.serve.pack import PackedWeight

K, N = 512, 256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jlab(tmp_path_factory):
    """The JAX lab module, imported by path; the compilation-cache settings
    it makes on import are put back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    os.environ["JAXLSQ_COMPILE_CACHE"] = str(tmp_path_factory.mktemp("jax_cache"))
    try:
        spec = importlib.util.spec_from_file_location(
            "_int4_kernel_lab", os.path.join(REPO, "examples", "_int4_kernel_lab.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.pop("JAXLSQ_COMPILE_CACHE", None)
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def weights():
    """The JAX lab's draw (main(), seed 1) at K x N, and its activations."""
    r = np.random.RandomState(1)
    spec4 = JSpec.make(4, signed=True, symmetric=True, per_channel=True, axis=1)
    w = jnp.asarray(0.02 * r.randn(K, N).astype(np.float32))
    scale = jnp.asarray(0.001 + 0.0005 * r.rand(N).astype(np.float32))
    p4 = jquantize_weight(w, scale, jnp.zeros((N,)), spec4, bits=4)
    w4 = jnp.round(jnp.clip(w / scale[None, :], -8, 7)).astype(jnp.int4)
    xs = {m: r.randn(m, K).astype(np.float32) for m in (1, 4)}
    return p4, w4, xs


def _packed(p):
    """A JAX package ``PackedWeight`` as the port's, field by field."""
    return PackedWeight(**{k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else v
                           for k, v in np_tree(p).items()})


def _close(got, want):
    want = np.asarray(want)
    tol = 1e-5 * float(np.abs(want).max())
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol, (np.abs(got - want).max(), tol)


@pytest.mark.parametrize("m", [1, 4])
def test_plain_versions_match_the_jax_lab_kernels(jlab, weights, m):
    p4, w4, xs = weights
    x = xs[m]
    packed = _packed(p4)
    native = lab.pack_native(torch.from_numpy(np.array(w4.astype(jnp.int8))))
    scale = packed.scale
    with pltpu.force_tpu_interpret_mode():
        want_bf16 = jlab.run_bf16(jnp.asarray(x), p4, 8, 256, 128)
        want_native = jlab.run_native(jnp.asarray(x), w4, p4.scale.astype(jnp.float32),
                                      8, 256, 128)
    tx = torch.from_numpy(x)
    for got in (lab.run_bf16_plain(tx, packed), lab.run_bf16(tx, packed)):
        _close(got.numpy(), want_bf16)
    for got in (lab.run_native_plain(tx, native, scale), lab.run_native(tx, native, scale)):
        _close(got.numpy(), want_native)


def test_lab_weights_are_the_jax_labs(weights):
    p4, w4, _ = weights
    _, tp4, tw4, tscale, _ = lab.lab_weights(K, N, "cpu")
    np.testing.assert_array_equal(tp4.data.numpy(), np.asarray(p4.data))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(p4.scale))
    np.testing.assert_array_equal(
        lab.unpack_native(tw4).numpy(), np.asarray(w4.astype(jnp.int8)))


def test_pack_native_round_trips_and_refuses_odd_k():
    r = np.random.RandomState(2)
    q = torch.from_numpy(r.randint(-8, 8, size=(10, 7)).astype(np.int8))
    p = lab.pack_native(q)
    assert p.shape == (5, 7) and p.dtype == torch.int8
    assert torch.equal(lab.unpack_native(p), q)
    # byte (k, n): row 2k in the low nibble, row 2k + 1 in the high nibble
    assert int(p[2, 3]) & 0x0F == int(q[4, 3]) & 0x0F
    assert (int(p[2, 3]) >> 4) == int(q[5, 3])
    with pytest.raises(ValueError, match="K even"):
        lab.pack_native(q[:9])
    with pytest.raises(ValueError, match=r"\[-8, 7\]"):
        lab.pack_native(torch.full((4, 2), 9, dtype=torch.int8))
    with pytest.raises(ValueError, match=r"\[-8, 7\]"):
        lab.pack_native(torch.full((4, 2), -9, dtype=torch.int32))
