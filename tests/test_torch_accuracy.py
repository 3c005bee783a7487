"""The port's accuracy protocol (``jaxlsq_torch.lab.accuracy_parity``)
against the JAX package's ``examples/accuracy_parity.py`` (imported by path;
the compilation-cache settings it makes on import are put back):

* the grating formula (``grating_images``) on the JAX package's own draws
  (``make_batch``'s eight keys, drawn here as it draws them) gives its
  images within 1e-5 of their largest magnitude (sin and cos are other
  implementations in XLA and in torch), and the same labels;
* ``paired_delta`` and ``summarize`` equal the JAX package's on fixed
  predictions of three seeds;
* the lr the training loop writes before each step of a 10-step run equals
  optax's ``cosine_decay_schedule(3e-3, 10)`` at that step (within 1e-7 of
  3e-3: optax computes it in f32, here in f64), and the optimizer is AdamW
  with optax's weight decay, 1e-4;
* ``run_seed`` runs the whole protocol on the CPU at a toy size (a narrow
  MobileNetV2, 2 steps of B = 4, 8 eval images, 2 re-estimation batches)
  and records the three top-1s and their paired deltas.
"""

import functools
import importlib.util
import os

import jax
import numpy as np
import optax
import pytest
import torch

from jaxlsq_torch.lab import accuracy_parity as ap
from jaxlsq_torch.models import QuantCNN, QuantMobileNetV2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jap():
    """The JAX package's protocol module, imported by path; the
    compilation-cache settings it makes on import are put back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "_jax_accuracy_parity", os.path.join(REPO, "examples", "accuracy_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@functools.partial(jax.jit, static_argnums=1)
def _jax_draws(key, n):
    """``make_batch``'s draws from ``key``, as it draws them (NHWC)."""
    ks = jax.random.split(key, 8)
    return {"labels": jax.random.randint(ks[0], (n,), 0, ap.N_CLASSES),
            "theta_noise": jax.random.normal(ks[1], (n,)),
            "freq": jax.random.uniform(ks[2], (n,), minval=2.0, maxval=6.0),
            "phase": jax.random.uniform(ks[3], (n,), minval=0.0, maxval=2 * np.pi),
            "amp": jax.random.uniform(ks[4], (n,), minval=0.15, maxval=1.0),
            "gxy": 0.5 * jax.random.normal(ks[5], (n, 2, 1, 1)),
            "tint": jax.random.uniform(ks[6], (n, 1, 1, 3), minval=0.7, maxval=1.3),
            "noise": jax.random.normal(ks[7], (n, ap.SIZE, ap.SIZE, 3))}


def test_grating_formula_on_jax_draws(jap):
    n = 64
    key = jax.random.key(3)
    want_x, want_y = jap.make_batch(key, n)
    d = {k: torch.from_numpy(np.array(v)) for k, v in _jax_draws(key, n).items()}
    d["tint"] = d["tint"].permute(0, 3, 1, 2)
    d["noise"] = d["noise"].permute(0, 3, 1, 2)
    got = ap.grating_images(d)
    want = np.asarray(want_x).transpose(0, 3, 1, 2)
    assert got.dtype == torch.float32 and got.shape == (n, 3, ap.SIZE, ap.SIZE)
    np.testing.assert_array_equal(d["labels"].numpy(), np.asarray(want_y))
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err
    # the port's own draws: the same shapes, ranges and label set
    x, y = ap.make_batch(n, torch.Generator().manual_seed(0), "cpu")
    assert x.shape == got.shape and y.dtype == torch.int64
    assert int(y.min()) >= 0 and int(y.max()) < ap.N_CLASSES


def test_paired_delta_and_summarize_equal_jax(jap):
    r = np.random.RandomState(1)
    labels = r.randint(0, ap.N_CLASSES, size=2000)
    mine, theirs = {}, {}
    seeds = [1, 2, 3]
    for s in seeds:
        base = np.where(r.rand(2000) < 0.9, labels, r.randint(0, ap.N_CLASSES, 2000))
        paired = {}
        for cfg, p_flip in (("w8a8", 0.03), ("w8a8_served", 0.04)):
            pred = np.where(r.rand(2000) < p_flip, (base + 1) % ap.N_CLASSES, base)
            got, want = ap.paired_delta(pred, base, labels), jap.paired_delta(pred, base,
                                                                                labels)
            assert got == want
            paired[cfg] = {"delta": round(got[0], 5), "paired_sigma": round(got[1], 6)}
        for res in (mine, theirs):
            res[f"m/seed{s}/paired"] = dict(paired)
    ap.summarize(mine, "m", seeds, cfgs=("w8a8",))
    jap.summarize(theirs, "m", seeds, cfgs=("w8a8",))
    assert mine == theirs and "m/summary/w8a8_served" in mine
    ap.summarize(mine, "m", seeds[:1], cfgs=("w8a8",))  # one seed: no interval
    assert np.isnan(mine["m/summary/w8a8"]["ci95_half_width"])


def test_cosine_lr_follows_optax_over_a_run():
    steps = 10
    run = ap.train(lambda qc: QuantCNN(ap.N_CLASSES, qc, widths=(4,), device="cpu"),
                   ap.recipe("combo1200"), steps, 2, seed=1, device="cpu")
    sched = jax.jit(jax.vmap(optax.cosine_decay_schedule(ap.BASE_LR, steps)))
    want = np.asarray(sched(np.arange(steps))).tolist()
    # optax's f32 cos next to pi: within f32 rounding of the base lr
    np.testing.assert_allclose(run["lrs"], want, rtol=0, atol=1e-7 * ap.BASE_LR)
    assert run["lrs"][0] == ap.BASE_LR and np.isfinite(run["loss"])
    for group in run["optimizer"].param_groups:
        assert group["weight_decay"] == 1e-4 and float(group["lr"]) == run["lrs"][-1]


def test_recipes_are_recipe_sweeps():
    qc = ap.recipe("combo1200_4").qconfig
    assert (qc.weight.spec.quant_min, qc.weight.spec.quant_max) == (-8, 7)
    assert (qc.activation.spec.quant_min, qc.activation.spec.quant_max) == (0, 255)
    assert qc.activation.n_batches == 1200 and qc.weight.spec.per_channel
    assert ap.recipe("float").qconfig.weight is None
    with pytest.raises(ValueError, match="unknown recipe"):
        ap.recipe("combo9")
    d4 = ap.recipe("distill4")
    assert d4.distill and d4.qconfig == qc and not ap.recipe("combo1200_4").distill


def test_run_seed_distills_from_the_seeds_float_model(monkeypatch):
    seen = []

    def narrow(num_classes, qc, device=None, seed=0):
        model = QuantMobileNetV2(num_classes, qc, stages=((1, 8, 1, 1),), stem_width=8,
                                 head_width=16, device=device, seed=seed)
        seen.append(model)
        return model

    real = ap.distillation_loss
    teachers = []
    monkeypatch.setitem(ap.MODELS, "mobilenetv2", narrow)
    monkeypatch.setattr(ap, "distillation_loss",
                        lambda t, **kw: teachers.append((t, kw)) or real(t, **kw))
    rec = ap.run_seed("mobilenetv2", "distill", 5, {}, steps=2, batch=4, device="cpu",
                      eval_n=8, eval_chunk=4, bn_batches=2, log=lambda line: None)
    assert sorted(rec["mobilenetv2/seed5/paired"]) == ["distill", "distill_bnreest",
                                                       "distill_served"]
    assert [t for t, _ in teachers] == [seen[0]]  # the float model of the seed
    assert teachers[0][1] == {"alpha": 0.5, "temperature": 2.0}
    assert seen[0].stem.weight_fq is None  # float: no quantizer


def test_run_seed_at_a_toy_size(monkeypatch):
    def narrow(num_classes, qc, device=None, seed=0):
        return QuantMobileNetV2(num_classes, qc, stages=((1, 8, 1, 1), (2, 8, 1, 2)),
                                stem_width=8, head_width=16, device=device, seed=seed)

    monkeypatch.setitem(ap.MODELS, "mobilenetv2", narrow)
    results = {}
    rec = ap.run_seed("mobilenetv2", "combo1200", 5, results, steps=2, batch=4,
                      device="cpu", eval_n=8, eval_chunk=4, bn_batches=2,
                      log=lambda line: None)
    row = rec["mobilenetv2/seed5/combo1200"]
    for k in ("top1", "top1_served", "top1_bnreest"):
        assert 0.0 <= row[k] <= 1.0
    paired = rec["mobilenetv2/seed5/paired"]
    assert sorted(paired) == ["combo1200", "combo1200_bnreest", "combo1200_served"]
    assert rec["mobilenetv2/seed5/float"]["steps_ran"] == 2
