"""The port's expensive observers (``MSEObserver``, ``PercentileObserver``,
``HistogramObserver``; their plain versions in ``jaxlsq_torch.ops.observers``)
against the JAX package's on the same seeded numpy batches, the histogram
also against ``torch.ao``'s, and the quantizer's traced forward with each of
them against the JAX package's ``_forward_traced`` across the window's end.

Tolerances:

* MSE: on batches whose best candidate beats the second by a margin the
  test asserts (1e-3 of its error), the same candidate, and the range within
  1e-6 relative (the port's candidate grid is ``jnp.linspace``'s formula in
  rounded f32 operations; XLA's grid lies up to an ulp off it); on plain
  Gaussian batches the JAX package's choice within 1e-5 relative of the
  port's least error (the candidates' errors are sums in another order).
* Percentile: 1e-6 relative (XLA may fuse the interpolation into an FMA).
* Histogram: the bins within 1e-6 of the histogram's mass (the old mass is
  spread by a scatter-add in another order), the union range exact, the
  searched range within one bin width (the cumulative sum and the error sum
  take other orders); the qparams within 1e-5 relative.  Against torch.ao:
  its own tests' tolerances (tests/test_histogram_observer.py).
* Traced forward: the percentile's range exact, the MSE's within 1e-6
  relative; the qparams within 1e-6 relative (1e-5 for the histogram: jaxlsq
  compiles its ``lax.cond`` branch, and XLA turns a division by a constant
  into a reciprocal product) and the outputs within a quant step; the
  port's traced and eager regimes bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.core.spec import QuantSpec as JSpec
from jaxlsq.models import default_qconfig as jdefault_qconfig
from jaxlsq.observers import histogram as jhist
from jaxlsq.observers import minmax as jminmax
from jaxlsq.observers.quantizer import LSQQuantizer as JQuantizer
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.models import default_qconfig
from jaxlsq_torch.observers import (HistogramObserver, LSQQuantizer, MinMaxObserver,
                                    MSEObserver, PercentileObserver)
from jaxlsq_torch.ops import observers as ops

ACT = dict(quant_min=0, quant_max=255)
NARROW = dict(quant_min=0, quant_max=127, type_min=0, type_max=255)
SYM = dict(quant_min=-127, quant_max=127, symmetric=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _outliers(shape, seed, scale=1.0):
    """ReLU-like activations with a few far outliers: the best MSE candidate
    clips them, well ahead of its neighbours."""
    r = np.random.RandomState(seed)
    x = np.maximum(r.randn(*shape), 0).astype(np.float32) * scale
    flat = x.reshape(-1)
    idx = r.choice(flat.size, max(1, flat.size // 2000), replace=False)
    flat[idx] = scale * (20 + 5 * r.rand(idx.size)).astype(np.float32)
    return x


def test_linspace_is_jnp_linspace_within_an_ulp():
    """``jnp.linspace``'s formula as rounded f32 operations.  XLA on the CPU
    does not round each operation of it (its constant-folded and its
    compiled grids differ from each other by an ulp too), so the grids agree
    within an ulp of their largest magnitude."""
    want = [np.asarray(jnp.linspace(1 / 64, 1.0, 64)),
            np.asarray(jax.jit(lambda: jnp.linspace(1 / 64, 1.0, 64))())]
    for w in want:
        np.testing.assert_allclose(ops.linspace(1 / 64, 1.0, 64).numpy(), w, rtol=0,
                                   atol=2.0 ** -23)
    r = np.random.RandomState(0)
    for lo, hi in ((-1.3, 2.7), (0.0, 1e-3), (-5e3, -4e3)):
        lo, hi = np.float32(lo + 0.01 * r.randn()), np.float32(hi + 0.01 * r.randn())
        ulp = 2.0 ** -23 * max(abs(lo), abs(hi))
        for num in (2049, 32769):
            np.testing.assert_allclose(
                ops.linspace(torch.tensor(lo), torch.tensor(hi), num).numpy(),
                np.asarray(jnp.linspace(jnp.float32(lo), jnp.float32(hi), num)),
                rtol=0, atol=ulp)


def _candidate(f_times_b, b):
    """The index of the candidate factor whose multiple of ``b`` is
    ``f_times_b`` (the nearest: XLA's grid may lie an ulp off the port's)."""
    f = ops.linspace(1 / 64, 1.0, 64).numpy().astype(np.float64)
    return int(np.argmin(np.abs(f * float(b) - float(f_times_b))))


# ------------------------------------------------------------------- MSE

def _jax_mse(kw, per_channel):
    obs = jminmax.MSEObserver(spec=JSpec(**kw), per_channel=per_channel, axis=1)
    return obs, jax.jit(obs.update)


@pytest.mark.parametrize("kw", [ACT, NARROW, SYM])
@pytest.mark.parametrize("per_channel", [False, True])
def test_mse_observer_matches_jax_on_margin_data(kw, per_channel):
    tobs = MSEObserver(spec=QuantSpec(**kw), per_channel=per_channel, axis=1)
    jobs, jupdate = _jax_mse(kw, per_channel)
    ts, js = tobs.init(6), jobs.init(6)
    for i in range(3):
        x = _outliers((4, 6, 10, 10), seed=10 + i, scale=1.0 + 0.5 * i)
        if kw.get("symmetric"):
            x = x - 0.5 * x.mean()
        bmin, bmax = _t(x).amin(dim=(0, 2, 3)), _t(x).amax(dim=(0, 2, 3))
        if not per_channel:
            bmin, bmax = bmin.min().reshape(1), bmax.max().reshape(1)
        _, _, errs, best = ops.mse_range_plain(_t(x), bmin, bmax, QuantSpec(**kw),
                                               per_channel, 1)
        srt = errs.sort(dim=1).values
        assert bool((srt[:, 1] - srt[:, 0] > 1e-3 * srt[:, 0]).all()), srt[:, :2]
        fresh = jupdate(jobs.init(6), jnp.asarray(x))  # a first update keeps the best
        nmin_j, nmax_j = np.asarray(fresh.min_val), np.asarray(fresh.max_val)
        for c in range(best.numel()):
            b, v = (bmax[c], nmax_j[c]) if float(bmax[c]) else (bmin[c], nmin_j[c])
            assert _candidate(v, b) == int(best[c]), (c, int(best[c]))
        ts = tobs.update(ts, _t(x))
        js = jupdate(js, jnp.asarray(x))
        for f in ("min_val", "max_val"):
            np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=1e-6, atol=0)
        assert int(ts.seen) == int(js.seen)
    for a, b in zip(tobs.calculate_qparams(ts, QuantSpec(**kw)),
                    jobs.calculate_qparams(js, JSpec(**kw))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


@pytest.mark.parametrize("per_channel", [False, True])
def test_mse_observer_choice_within_1e5_of_least_error(per_channel):
    spec = QuantSpec(**ACT)
    jobs = jminmax.MSEObserver(spec=JSpec(**ACT), per_channel=per_channel, axis=1,
                               averaging_constant=None)
    jbest = jax.jit(jobs._best_range)
    r = np.random.RandomState(3)
    for i in range(4):
        x = r.randn(8, 5, 6, 6).astype(np.float32) * (1 + i)
        nmin_j, nmax_j = (np.asarray(v) for v in jbest(jnp.asarray(x)))
        bmin, bmax = _t(x).amin(dim=(0, 2, 3)), _t(x).amax(dim=(0, 2, 3))
        if not per_channel:
            bmin, bmax = bmin.min().reshape(1), bmax.max().reshape(1)
        nmin, nmax, errs, _ = ops.mse_range_plain(_t(x), bmin, bmax, spec, per_channel, 1)
        for c in range(errs.shape[0]):
            k = _candidate(nmax_j[c], bmax[c])
            least = float(errs[c].min())
            assert float(errs[c, k]) <= least * (1 + 1e-5), (c, k, least)


def _level_shortcut(x, s, z, qmin, qmax):
    """csrc/observers.cu's ``mse_level`` in numpy: ``ta = fma(x, 1/s, z)``
    (the reciprocal rounded to f32, the fma's one rounding emulated in f64),
    the bound beyond qmax + 1 / qmin - 1, ``rint(ta)`` clamped more than
    2^-11 from a half-integer, else the f32 divide."""
    r = (1.0 / s.astype(np.float64)).astype(np.float32)
    ta = (x.astype(np.float64) * r.astype(np.float64) + z).astype(np.float32)
    exact = np.rint(np.clip(x / s + z, qmin, qmax)).astype(np.float32)
    far = np.abs(ta - np.floor(ta) - np.float32(0.5)) > np.float32(2.0 ** -11)
    out = np.where(far, np.clip(np.rint(ta), qmin, qmax), exact)
    out = np.where(ta <= qmin - 1, qmin, out)
    return np.where(ta >= qmax + 1, qmax, out).astype(np.float32), exact, far


@pytest.mark.parametrize("qmin,qmax", [(0, 255), (0, 127), (-127, 127), (-8, 7)])
def test_mse_level_shortcut_is_the_divide(qmin, qmax):
    """The MSE kernel's level shortcut gives the divide's level on 2 M
    random and near-half-integer values (the kernel's CPU emulation)."""
    r = np.random.RandomState(qmax - qmin)
    n = 1 << 20
    s = np.exp(r.uniform(np.log(1.2e-7), np.log(10.0), n)).astype(np.float32)
    z = r.randint(qmin, qmax + 1, n).astype(np.float32)
    # values whose x / s + z lands next to a half-integer, at any level
    t = (r.randint(qmin - 3, qmax + 3, n) + 0.5 + r.uniform(-1e-3, 1e-3, n))
    x_near = ((t - z) * s.astype(np.float64)).astype(np.float32)
    x_any = (r.randn(n) * s * (qmax - qmin) / 3).astype(np.float32)
    fars = []
    for x in (x_near, x_any):
        got, want, far = _level_shortcut(x, s, z, np.float32(qmin), np.float32(qmax))
        np.testing.assert_array_equal(got, want)
        fars.append(far.mean())
    assert 0.3 < fars[0] < 0.9 and fars[1] > 0.99  # the near values take both paths


def test_mse_observer_fields_match_jax():
    j = jdefault_qconfig(8, 8, act_observer="mse").activation.observer
    t = default_qconfig(8, 8, act_observer="mse").activation.observer
    assert isinstance(t, MSEObserver) and t.expensive_update and j.expensive_update
    assert (t.num_candidates, t.averaging_constant, t.per_channel) == (
        j.num_candidates, j.averaging_constant, j.per_channel)
    assert (t.spec.quant_min, t.spec.quant_max) == (j.spec.quant_min, j.spec.quant_max)


# ------------------------------------------------------------ percentile

@pytest.mark.parametrize("cap", [None, 1 << 16, 1024])
@pytest.mark.parametrize("per_channel", [False, True])
def test_percentile_observer_matches_jax(cap, per_channel):
    kw = dict(percentile=99.9, per_channel=per_channel, axis=1, sample_cap=cap)
    tobs, jobs = PercentileObserver(**kw), jminmax.PercentileObserver(**kw)
    jupdate = jax.jit(jobs.update)
    ts, js = tobs.init(3), jobs.init(3)
    r = np.random.RandomState(5)
    for i in range(3):
        x = (r.standard_t(3, size=(8, 3, 48, 48)) * (1 + i)).astype(np.float32)
        ts = tobs.update(ts, _t(x))
        js = jupdate(js, jnp.asarray(x))
        for f in ("min_val", "max_val"):
            np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=1e-6, atol=0)
        assert int(ts.seen) == int(js.seen)


def test_percentile_observer_checks_its_arguments():
    with pytest.raises(ValueError, match=r"\(50, 100\]"):
        PercentileObserver(percentile=40.0)
    with pytest.raises(ValueError, match="1024"):
        PercentileObserver(sample_cap=512)
    x = np.arange(20, dtype=np.float32).reshape(4, 5)
    x[1, 2] = np.nan  # a NaN makes the range NaN, as jnp.percentile's
    st = PercentileObserver().update(PercentileObserver().init(1), _t(x))
    assert np.isnan(st.min_val.numpy()).all() and np.isnan(st.max_val.numpy()).all()


# ------------------------------------------------------------- histogram

BINS = 256

HIST_CASES = {
    "growth": lambda r: [r.randn(1024), r.randn(1024) * 4 + 1, r.randn(512) * 0.5],
    "constant": lambda r: [np.full(300, 1.5), np.full(200, 1.5)],
    "degenerate_then_wider": lambda r: [np.full(300, 0.25), r.randn(800)],
    "narrowed": lambda r: [r.randn(2048) * 3, (r.rand(512) - 0.5) * 0.5],
    "relu": lambda r: [np.maximum(r.randn(4096), 0) * (1 + i) for i in range(3)],
}


def _hist_pair(bins=BINS):
    return HistogramObserver(bins=bins), jhist.HistogramObserver(bins=bins)


# jaxlsq's histogram programs, compiled once for the module
_JHIST = jhist.HistogramObserver(bins=BINS)
_JHIST_UPDATE = jax.jit(_JHIST.update)
_JHIST_SEARCH = jax.jit(_JHIST._search, static_argnums=1)
_JHIST_QPARAMS = jax.jit(_JHIST.calculate_qparams, static_argnums=1)


@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_histogram_observer_matches_jax(case):
    tobs, jobs = HistogramObserver(bins=BINS), _JHIST
    jupdate, jsearch, jqparams = _JHIST_UPDATE, _JHIST_SEARCH, _JHIST_QPARAMS
    ts, js = tobs.init(1), jobs.init(1)
    r = np.random.RandomState(7)
    for x in HIST_CASES[case](r):
        x = np.asarray(x, np.float32)
        ts = tobs.update(ts, _t(x))
        js = jupdate(js, jnp.asarray(x))
        np.testing.assert_array_equal(ts.min_val.numpy(), np.asarray(js.min_val))
        np.testing.assert_array_equal(ts.max_val.numpy(), np.asarray(js.max_val))
        mass = float(np.asarray(js.histogram).sum())
        np.testing.assert_allclose(ts.histogram.numpy(), np.asarray(js.histogram), rtol=0,
                                   atol=1e-6 * mass)
        assert int(ts.seen) == int(js.seen)
    # the search on the last state (a degenerate histogram's runs ~50,000
    # trips in jaxlsq's loop: one spec)
    for spec_kw in (ACT,) if case == "constant" else (ACT, NARROW, SYM):
        dst = spec_kw.get("type_max", spec_kw["quant_max"]) - spec_kw.get(
            "type_min", spec_kw["quant_min"]) + 1
        got, _ = ops.hist_search_plain(ts.histogram, ts.min_val, ts.max_val, dst)
        want = np.concatenate([np.asarray(v) for v in jsearch(js, dst)])
        width = float(ts.max_val - ts.min_val) / BINS
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=width + 1e-12)
        if spec_kw is ACT and got.numpy().tolist() == want.tolist():
            for a, b in zip(tobs.calculate_qparams(ts, QuantSpec(**spec_kw)),
                            jqparams(js, JSpec(**spec_kw))):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_fresh_histogram_observer_gives_one_and_zero():
    tobs, jobs = _hist_pair()
    for spec in (ACT, SYM):
        a = tobs.calculate_qparams(tobs.init(1), QuantSpec(**spec))
        b = jobs.calculate_qparams(jobs.init(1), JSpec(**spec))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            assert x.tolist() in ([1.0], [0.0])
    with pytest.raises(ValueError, match="per-tensor only"):
        tobs.init(4)


@pytest.mark.parametrize("widen", [False, True])
def test_histogram_tracks_torch_ao(widen):
    from torch.ao.quantization.observer import HistogramObserver as TorchHist

    r = np.random.RandomState(0)
    batches = [r.randn(1024).astype(np.float32)]
    if widen:
        batches += [r.randn(1024).astype(np.float32) * 4.0 + 1.0,
                    r.randn(512).astype(np.float32)]
    else:
        batches.append((r.rand(512).astype(np.float32) - 0.5) * 0.5)
    ref = TorchHist(bins=BINS, dtype=torch.quint8, qscheme=torch.per_tensor_affine)
    tobs = HistogramObserver(bins=BINS)
    st = tobs.init(1)
    for b in batches:
        ref(_t(b))
        st = tobs.update(st, _t(b))
    np.testing.assert_allclose(float(st.min_val), ref.min_val.item(), rtol=1e-6)
    np.testing.assert_allclose(float(st.max_val), ref.max_val.item(), rtol=1e-6)
    np.testing.assert_allclose(st.histogram.numpy(), ref.histogram.numpy(), atol=1e-3)
    scale, zp = tobs.calculate_qparams(st, QuantSpec(**ACT))
    rs, rz = ref.calculate_qparams()
    np.testing.assert_allclose(float(scale), rs.item(), rtol=1e-3)
    assert abs(int(zp) - rz.item()) <= 1


# ------------------------------------------------- the quantizer, traced

OBSERVERS = {
    "mse": (lambda: MSEObserver(spec=QuantSpec(**ACT)),
            lambda: jminmax.MSEObserver(spec=JSpec(**ACT))),
    "percentile": (lambda: PercentileObserver(sample_cap=1024),
                   lambda: jminmax.PercentileObserver(sample_cap=1024)),
    "histogram": (lambda: HistogramObserver(bins=BINS),
                  lambda: jhist.HistogramObserver(bins=BINS)),
}


@pytest.mark.parametrize("name", sorted(OBSERVERS))
def test_traced_forward_matches_jax_across_the_window(name):
    """n_batches = 2: two window calls, the switch, two LSQ calls; the
    expensive observer runs inside the window only (jaxlsq's lax.cond, the
    port's gate), and the traced and eager regimes agree bit for bit."""
    make_t, make_j = OBSERVERS[name]
    tq = LSQQuantizer(QuantSpec(**ACT), n_batches=2, init_scale=0.05, observer=make_t())
    jq = JQuantizer(JSpec(**ACT), n_batches=2, init_scale=0.05, observer=make_j(),
                    impl="reference")
    # op by op, as tests/test_torch_traced.py runs it: under jit XLA turns
    # observer_qparams' divisions by constants into reciprocal products
    def jstep(st, x):
        return jq._forward_traced(st, x, True)

    ts, es, js = tq.init(device="cpu").on_device(), tq.init(device="cpu"), jq.init()
    for i in range(5):
        x = _outliers((4, 3, 12, 12), seed=30 + i, scale=1.0 + 0.3 * i)
        jout, js = jstep(js, jnp.asarray(x))
        tout, ts = tq.forward_traced(ts, _t(x), True)
        eout, es = tq(es, _t(x), training=True)
        np.testing.assert_array_equal(tout.numpy(), eout.numpy())
        for f in dataclasses.fields(ts.obs):
            np.testing.assert_array_equal(getattr(ts.obs, f.name).numpy(),
                                          getattr(es.obs, f.name).numpy())
        assert bool(ts.observer_enabled) == es.observer_enabled == bool(js.observer_enabled)
        np.testing.assert_array_equal(ts.obs.seen.numpy(), np.asarray(js.obs.seen))
        if name == "histogram":
            np.testing.assert_array_equal(ts.obs.min_val.numpy(), np.asarray(js.obs.min_val))
            np.testing.assert_array_equal(ts.obs.max_val.numpy(), np.asarray(js.obs.max_val))
            mass = float(np.asarray(js.obs.histogram).sum())
            np.testing.assert_allclose(ts.obs.histogram.numpy(), np.asarray(js.obs.histogram),
                                       rtol=0, atol=1e-6 * mass)
            np.testing.assert_allclose(ts.scale.numpy(), np.asarray(js.scale), rtol=1e-5)
            np.testing.assert_allclose(ts.shift.numpy(), np.asarray(js.shift), rtol=1e-5,
                                       atol=1e-5 * float(ts.scale))
            step = float(ts.scale)
            assert float(np.abs(tout.numpy() - np.asarray(jout)).max()) <= step * 1.001
        else:
            # jaxlsq compiles its lax.cond branch, and XLA turns observer_qparams'
            # division by a constant into a reciprocal product: an ulp
            rtol = 1e-6 if name == "mse" else 0
            np.testing.assert_allclose(ts.obs.min_val.numpy(), np.asarray(js.obs.min_val),
                                       rtol=rtol, atol=0)
            np.testing.assert_allclose(ts.obs.max_val.numpy(), np.asarray(js.obs.max_val),
                                       rtol=rtol, atol=0)
            np.testing.assert_allclose(ts.scale.numpy(), np.asarray(js.scale), rtol=1e-6)
            np.testing.assert_allclose(ts.shift.numpy(), np.asarray(js.shift), rtol=1e-6,
                                       atol=1e-6 * float(ts.scale))
            step = float(ts.scale)
            assert float(np.abs(tout.numpy() - np.asarray(jout)).max()) <= step * 1.001
    assert int(ts.obs.seen) == 2 and not bool(ts.observer_enabled)


# --------------------------------------------------------------- qconfig

@pytest.mark.parametrize("name", ["minmax", "mse", "percentile", "histogram"])
def test_default_qconfig_builds_each_observer(name):
    t = default_qconfig(8, 8, act_observer=name, init_batches=3).activation
    j = jdefault_qconfig(8, 8, act_observer=name, init_batches=3).activation
    want = {"minmax": MinMaxObserver, "mse": MSEObserver, "percentile": PercentileObserver,
            "histogram": HistogramObserver}[name]
    assert type(t.observer) is want and type(t.observer).__name__ == type(j.observer).__name__
    assert t.observer.expensive_update == j.observer.expensive_update
    if name == "percentile":
        assert (t.observer.percentile, t.observer.sample_cap) == (
            j.observer.percentile, j.observer.sample_cap)
    if name == "histogram":
        assert (t.observer.bins, t.observer.upsample_rate) == (
            j.observer.bins, j.observer.upsample_rate)
    with pytest.raises(ValueError, match="unknown act_observer"):
        default_qconfig(8, 8, act_observer="entropy")
