"""``torch.export`` of the serving programs and the host C++ components,
against the port's eager paths and the JAX package's counterparts.

Export (``jaxlsq_torch.serve.export``), on the JAX package's serve-mode LM
(vocab 64, d32, depth 1, 4 heads, max_len 16; its jitted ``init`` converted
and carried across with ``interop``), B = 2:

* the exported forward (``load_exported(blob)(state, x)``) bit for bit the
  eager port's, within 1e-5 of the JAX package's ``export_serving_forward``
  artifact (the sums run in another order); the grouped-int4 pack and the
  ``'static_int8'`` forward (the int8 operators) bit for bit the eager
  port's;
* the calling convention enforced (another batch size or a missing weight
  raises); the artifact holds no weight (no tensor data in the archive);
  a fresh process that imports only ``torch`` and
  ``jaxlsq_torch.serve.custom_ops``, not the model classes, replays it bit
  for bit;
* the exported greedy generate (prompt 4, 6 new tokens): at f32 and bf16
  caches its tokens equal the eager ``make_generate``'s and the JAX
  package's ``export_generate``'s; at int8 and int4 caches they equal the
  eager ones, and the logits along them lie within 1e-3 of the JAX
  package's (ROADMAP deviation 4: the quantize-on-write can round the other
  way).

Native (``jaxlsq_torch.native``): the forward, dX and int8 quantization of
the port's copy of ``lsq_ref.cpp`` bit for bit the JAX package's library and
the port's golden functions, dS/dB within 1e-5 of the sum of their terms'
magnitudes (each library folds its OpenMP threads' partials in the order
they finish); ``NativeShardLoader`` batches (torch tensors) equal to the JAX
package's loader on the same shards and seed at several ``workers`` and
``prefetch``, over an epoch boundary.
"""

import io
import itertools
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import np_tree
from jaxlsq.core.spec import QuantSpec as JQuantSpec
from jaxlsq.models import QuantTransformerLM as JLM
from jaxlsq.models import default_qconfig as j_default_qconfig
from jaxlsq.native import NativeShardLoader as JNativeShardLoader
from jaxlsq.native import native_backward as j_native_backward
from jaxlsq.native import native_forward as j_native_forward
from jaxlsq.native import native_quantize_i8 as j_native_quantize_i8
from jaxlsq.serve import convert as j_convert
from jaxlsq.serve import prefill as j_prefill
from jaxlsq.serve.export import export_generate as j_export_generate
from jaxlsq.serve.export import export_serving_forward as j_export_forward
from jaxlsq.serve.export import load_exported as j_load_exported
from jaxlsq_torch import interop
from jaxlsq_torch.core.golden import effective_grad_scale, golden_backward, golden_forward
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.models import QuantTransformerLM, default_qconfig
from jaxlsq_torch.native import (NativeShardLoader, native_backward, native_forward,
                                 native_quantize_i8)
from jaxlsq_torch.serve import (convert, export_generate, export_serving_forward,
                                load_exported, load_exported_file, make_generate, prefill,
                                save_exported_file)

VOCAB, DIM, DEPTH, HEADS, MAXLEN = 64, 32, 1, 4, 16
T0, NEW = 4, 6  # the generate's prompt and new tokens
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lm():
    """The JAX package's LM (w8, per-channel), its converted tree, and the
    port's serve-mode twins ('none' and 'static_int8')."""
    jqc = j_default_qconfig(8, 8, per_channel_weights=True, init_batches=1)
    jm = JLM(vocab=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS, qconfig=jqc, max_len=MAXLEN)
    tokens = np.random.RandomState(0).randint(0, VOCAB, (2, 16)).astype(np.int32)
    variables = jax.jit(lambda t: jm.init(jax.random.key(0), t, training=False))(
        jnp.asarray(tokens))
    sv = jax.jit(lambda v: j_convert(v, jqc))(variables)
    jsm = jm.clone(qconfig=jqc.for_serving("none", "xla"))
    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=1)
    out = {"jsm": jsm, "sv": sv, "tokens": tokens, "variables": np_tree(variables)}
    for act_mode in ("none", "static_int8"):
        tm = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, qc.for_serving(act_mode),
                                max_len=MAXLEN, device="cpu")
        interop.load_variables(tm, out["variables"])
        out[act_mode] = tm.eval()
    return out


def _archive_entries(blob):
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        return {i.filename: i.file_size for i in z.infolist()}


def test_forward_round_trip(lm, tmp_path):
    tm = lm["none"]
    state = tm.state_dict()
    x = torch.as_tensor(lm["tokens"])
    blob = export_serving_forward(tm, state, x)
    with torch.no_grad():
        want = tm(x)
    got = load_exported(blob)(state, x)
    assert torch.equal(got, want)
    path = save_exported_file(str(tmp_path / "fwd.pt2"), blob)
    assert torch.equal(load_exported_file(path)(state, x), want)
    jblob = j_export_forward(lm["jsm"], lm["sv"], jnp.asarray(lm["tokens"]))
    ref = np.asarray(j_load_exported(jblob)(lm["sv"], jnp.asarray(lm["tokens"])))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_calling_convention_enforced(lm):
    tm = lm["none"]
    state = tm.state_dict()
    x = torch.as_tensor(lm["tokens"])
    blob = export_serving_forward(tm, state, x)
    fn = load_exported(blob)
    with pytest.raises(Exception):
        fn(state, x[:1])
    partial = dict(state)
    partial.pop("block0.qkv.kernel.data")
    with pytest.raises(Exception):
        fn(partial, x)
    # no weight is saved: the example inputs empty, no parameter or constant
    entries = _archive_entries(blob)
    data = {n: size for n, size in entries.items() if n.startswith("archive/data/")}
    assert data == {"archive/data/weights/model_weights_config.json": 14,
                    "archive/data/constants/model_constants_config.json": 14,
                    "archive/data/sample_inputs/model.pt": 0}, data
    with pytest.raises(ValueError, match="eval mode"):
        export_serving_forward(tm.train(), state, x)
    tm.eval()


def test_replayed_in_a_process_without_the_model_classes(lm, tmp_path):
    tm = lm["none"]
    state = tm.state_dict()
    x = torch.as_tensor(lm["tokens"])
    path = save_exported_file(str(tmp_path / "fwd.pt2"), export_serving_forward(tm, state, x))
    torch.save({"state": dict(state), "x": x}, str(tmp_path / "args.pt"))
    code = (
        "import sys, torch\n"
        "import jaxlsq_torch.serve.custom_ops\n"
        f"a = torch.load({str(tmp_path / 'args.pt')!r})\n"
        f"ep = torch.export.load({path!r})\n"
        "out = ep.module()(a['state'], a['x'])\n"
        f"torch.save(out, {str(tmp_path / 'out.pt')!r})\n"
        "bad = [m for m in sys.modules if m.startswith(('jaxlsq_torch.models', "
        "'jaxlsq_torch.interop')) or m.split('.')[0] in ('jax', 'jaxlsq', 'flax')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with torch.no_grad():
        assert torch.equal(torch.load(str(tmp_path / "out.pt")), tm(x))


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_generate_round_trip_equals_jaxlsq(lm, cache):
    tm = lm["none"]
    state = tm.state_dict()
    prompt = torch.as_tensor(lm["tokens"][:, :T0])
    blob = export_generate(tm, state, T0, NEW, batch_size=2, cache_dtype=getattr(torch, cache))
    got = load_exported(blob)(state, prompt)
    assert got.dtype == torch.int32 and got.shape == (2, NEW)
    assert torch.equal(got, make_generate(tm, T0, NEW, cache_dtype=getattr(torch, cache))(prompt))
    jblob = j_export_generate(lm["jsm"], lm["sv"], T0, NEW, batch_size=2,
                              cache_dtype=getattr(jnp, cache))
    want = np.asarray(j_load_exported(jblob)(lm["sv"], jnp.asarray(lm["tokens"][:, :T0])))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(Exception):
        load_exported(blob)(state, prompt[:, :T0 - 1])


def _decode_logits(tm, seq, t0, cache):
    last, c, idx = prefill(tm, seq[:, :t0], cache_dtype=cache)
    out = [last]
    with torch.no_grad():
        for t in range(t0, seq.shape[1]):
            logits, c = tm(seq[:, t:t + 1], cache=c, cache_index=idx)
            out.append(logits[:, 0])
            idx += 1
    return torch.stack(out, 1).numpy()


def _jax_decode_logits(model, variables, seq, t0, cache):
    last, c, idx = jax.jit(lambda v, t: j_prefill(model, v, t, cache_dtype=cache))(
        variables, jnp.asarray(seq[:, :t0]))
    step = jax.jit(lambda v, tok, c, i: model.apply(v, tok, cache=c, cache_index=i))
    out = [np.asarray(last)]
    for t in range(t0, seq.shape[1]):
        logits, c = step(variables, jnp.asarray(seq[:, t:t + 1]), c, idx)
        out.append(np.asarray(logits[:, 0]))
        idx = idx + 1
    return np.stack(out, 1)


@pytest.mark.parametrize("cache", ["int8", "int4"])
def test_generate_quantized_caches(lm, cache):
    tm = lm["none"]
    state = tm.state_dict()
    prompt = torch.as_tensor(lm["tokens"][:, :T0])
    tdt = torch.int8 if cache == "int8" else "int4"
    got = load_exported(export_generate(tm, state, T0, NEW, batch_size=2,
                                        cache_dtype=tdt))(state, prompt)
    assert torch.equal(got, make_generate(tm, T0, NEW, cache_dtype=tdt)(prompt))
    seq = torch.cat([prompt, got[:, :-1]], 1)
    np.testing.assert_allclose(
        _decode_logits(tm, seq, T0, tdt),
        _jax_decode_logits(lm["jsm"], lm["sv"], seq.numpy(), T0,
                           jnp.int8 if cache == "int8" else "int4"),
        rtol=1e-3, atol=1e-3)


def test_grouped_and_static_int8_forwards_round_trip(lm):
    x = torch.as_tensor(lm["tokens"])
    qc4 = default_qconfig(4, 8, per_channel_weights=True, init_batches=1).for_serving("none")
    grouped = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, qc4, max_len=MAXLEN, device="cpu")
    tree = convert({k: v for k, v in lm["variables"].items()}, qc4, weight_group_size=16)
    interop.load_variables(grouped, tree)
    assert grouped.block0.mlp_up.kernel.group_size == 16
    for tm in (grouped.eval(), lm["static_int8"]):
        state = tm.state_dict()
        with torch.no_grad():
            want = tm(x)
        assert torch.equal(load_exported(export_serving_forward(tm, state, x))(state, x), want)


# ----------------------------------------------------------------- native

def _specs():
    out = []
    for symmetric, per_channel in itertools.product([False, True], repeat=2):
        out.append(dict(bits=8, signed=symmetric, symmetric=symmetric,
                        per_channel=per_channel, axis=1))
    out.append(dict(bits=8, signed=True, symmetric=True, narrow_to_bits=7))
    out.append(dict(bits=4, signed=True, symmetric=True, per_channel=True, axis=1))
    return out


def _data(spec, seed=0, shape=(6, 12, 5)):
    r = np.random.RandomState(seed)
    x = (2 * r.randn(*shape)).astype(np.float32)
    g = r.randn(*shape).astype(np.float32)
    c = shape[spec.axis] if spec.per_channel else 1
    scale = (0.05 + 0.03 * r.rand(c)).astype(np.float32)
    shift = (np.zeros(c) if spec.symmetric else 0.02 * r.randn(c)).astype(np.float32)
    return x, g, scale, shift


def _term_sums(g, x, scale, shift, spec, init_mode):
    """Per qparam, |gs| times the sum of the magnitudes of dS's and dB's
    terms, in f64 (phase 2's tolerance base: the scale of a difference in
    summation order)."""
    x, g = x.astype(np.float64), g.astype(np.float64)
    axis = spec.axis % x.ndim if spec.per_channel else None
    shape = [1] * x.ndim
    if axis is not None:
        shape[axis] = -1
    s = np.maximum(np.abs(scale.astype(np.float64)), 2.0 ** -23).reshape(shape)
    b = shift.astype(np.float64).reshape(shape)
    zp = np.round(np.clip(-b / s, spec.type_min, spec.type_max))
    xq = np.clip(x / s + zp, spec.quant_min, spec.quant_max)
    inside = (spec.quant_min < xq) & (xq < spec.quant_max)
    xfq = (np.round(xq) - zp) * s
    geff = 2 * (xfq - x) if init_mode else g
    ds = np.abs(np.where(inside, geff * (xfq - x) / s,
                         np.where(xq <= spec.quant_min, geff * (spec.quant_min - zp),
                                  geff * (spec.quant_max - zp))))
    db = np.abs(np.where(inside, 0.0, geff))
    red = tuple(a for a in range(x.ndim) if a != axis)
    gs = abs(effective_grad_scale(spec, x.size, scale.size))
    return ds.sum(axis=red) * gs, db.sum(axis=red) * gs


@pytest.mark.parametrize("kw", _specs(), ids=str)
@pytest.mark.parametrize("eval_mode,init_mode", [(False, False), (True, False), (False, True)])
def test_native_ops_match_jaxlsq_and_golden(kw, eval_mode, init_mode):
    kw = dict(kw)
    bits = kw.pop("bits")
    spec, jspec = QuantSpec.make(bits, **kw), JQuantSpec.make(bits, **kw)
    x, g, scale, shift = _data(spec)
    fwd = native_forward(x, scale, shift, spec, init_mode=init_mode)
    np.testing.assert_array_equal(fwd, j_native_forward(x, scale, shift, jspec,
                                                        init_mode=init_mode))
    gold = golden_forward(torch.from_numpy(x), torch.from_numpy(scale),
                          torch.from_numpy(shift), spec, init_mode=init_mode).numpy()
    np.testing.assert_array_equal(fwd, gold)
    np.testing.assert_array_equal(native_quantize_i8(x, scale, shift, spec),
                                  j_native_quantize_i8(x, scale, shift, jspec))
    dx, ds, db = native_backward(g, x, scale, shift, spec, eval_mode=eval_mode,
                                 init_mode=init_mode)
    jdx, jds, jdb = j_native_backward(g, x, scale, shift, jspec, eval_mode=eval_mode,
                                      init_mode=init_mode)
    gdx, gds, gdb = (t.numpy() for t in golden_backward(
        torch.from_numpy(g), torch.from_numpy(x), torch.from_numpy(scale),
        torch.from_numpy(shift), spec, eval_mode=eval_mode, init_mode=init_mode))
    np.testing.assert_array_equal(dx, jdx)
    np.testing.assert_array_equal(dx, gdx)
    ts, tb = _term_sums(g, x, scale, shift, spec, init_mode)
    for got, ref, tol in ((ds, jds, ts), (ds, gds, ts), (db, jdb, tb), (db, gdb, tb)):
        assert got.shape == ref.shape
        assert np.all(np.abs(got - ref) <= 1e-5 * tol.reshape(got.shape))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    r = np.random.RandomState(11)
    out = []
    for i, n in enumerate((37, 50, 29)):
        x = r.randn(n, 4, 3).astype(np.float32)
        y = (np.arange(n) + 1000 * i).astype(np.int32)
        np.save(d / f"x{i}.npy", x)
        np.save(d / f"y{i}.npy", y)
        out.append((str(d / f"x{i}.npy"), str(d / f"y{i}.npy")))
    return out


@pytest.mark.parametrize("workers,prefetch", [(1, 1), (2, 4), (4, 2)])
def test_shard_loader_batches_equal_jaxlsq(shards, workers, prefetch):
    with JNativeShardLoader(shards, 16, seed=5, workers=3, prefetch=3) as ref:
        want = [ref.next() for _ in range(9)]  # past one epoch (7 batches)
    with NativeShardLoader(shards, 16, seed=5, workers=workers, prefetch=prefetch) as ld:
        assert (ld.num_examples, ld.batches_per_epoch) == (116, 7)
        for wx, wy in want:
            x, y = ld.next()
            assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
            np.testing.assert_array_equal(x.numpy(), wx)
            np.testing.assert_array_equal(y.numpy(), wy)
        assert ld.delivered == 9
    with pytest.raises(RuntimeError, match="closed"):
        ld.next()


def test_shard_loader_unlabeled_and_errors(shards):
    xs = [s[0] for s in shards]
    with NativeShardLoader(xs, 8, seed=1) as ld, JNativeShardLoader(xs, 8, seed=1) as ref:
        for _ in range(3):
            np.testing.assert_array_equal(ld.next().numpy(), ref.next())
    with pytest.raises(ValueError, match="no shards"):
        NativeShardLoader([], 8)
    with pytest.raises(ValueError, match="labels"):
        NativeShardLoader([shards[0], xs[1]], 8)
