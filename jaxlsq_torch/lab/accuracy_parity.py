"""jaxlsq's QAT accuracy protocol on the port (port of
``examples/accuracy_parity.py`` with ``examples/recipe_sweep.py``'s recipes
and its BatchNorm re-estimation).

The task is jaxlsq's procedural grating problem: 36 orientation classes 5
degrees apart on 32x32x3 images, with frequency, phase, amplitude, a
background gradient, a tint and noise as nuisances.  :func:`grating_draws`
draws its random inputs from a ``torch.Generator`` on the device (the JAX
package's distributions, not its bits) and :func:`grating_images` is the pure
formula of ``make_batch`` on them, NCHW.

Per seed, every config trains from the same initial weights (seed 0, as the
JAX package's ``create_train_state`` uses one key) on the same sequence of
batches, with its recipe's optimizer (:func:`recipe`: ``AdamW(lr,
weight_decay=1e-4)``, optax's ``adamw`` default decay, or the
``qat_optimizer`` partitions of ``sgdq_tx``/``adamq_tx``) under the cosine
schedule ``3e-3 * 0.5 * (1 + cos(pi * min(i, steps) / steps))`` written into
every param group before step i, through ``make_train_step(jit=True)``: on
the card one CUDA graph of the step whose lr is read from the device
(``capturable=True``, ``fused=True``).  Before training, one eval-mode
forward on a batch of its own feeds the activation observers, as flax's
``init`` does; then the recipe's state function (``set_static_estimate``)
and its warm start (``calibrate`` over 20 batches, then learning on and the
observers off, as ``train_one`` does).  One float model a seed is shared by
every recipe of the seed, and it is the teacher of the ``distill*`` recipes
(``distillation_loss``, alpha 0.5, T 2.0, as the sweep's loop).  The eval
set is a fixed 20,000 images a seed, in chunks of 2,000, shared by every
config of the seed.  A QAT row records
three top-1s: ``top1`` (the QAT model in eval mode), ``top1_served`` (the
trained variables through ``serve.convert`` into the serve-mode model under
``for_serving('static')``: packed kernels, static activation quantization,
the classifier through ``wo8``/``wo4``) and ``top1_bnreest`` (the QAT model
after ``reestimate_batch_stats`` over 400 batches), each with its paired
delta against the seed's float model and its McNemar sigma; the summary is
the mean over seeds with its 95% t-interval.  The mixed-precision recipes
(``mp4_48``, ``mp4_56``) follow the sweep's flow: a ``combo1200_4`` scout
is trained once a seed, ``plan_mixed_precision`` (weights at 4 or 8 bits,
an average of 4.8 or 5.6) runs on it over a batch drawn from 424,242 +
seed, and the recipe trains fresh under the planned qconfig; its rows carry
``avg_bits``, ``n_int8`` and ``n_scopes``, and it serves mixed carriers
(``wo8`` for the int8 layers, ``wo4`` for the rest).  On the card::

    python3 -m jaxlsq_torch.lab.accuracy_parity --models mobilenetv2 \\
        --recipe combo1200[,mse,...] --seeds 3 [--seed-start S] [--steps 1500] \\
        [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from .. import interop
from .._device import resolve_device
from ..models import QConfig, calibrate, default_qconfig, map_quant_state
from ..models.calibrate import set_static_estimate
from ..models.zoo import mobilenetv2_cifar, resnet18_cifar
from ..observers import MovingAverageMinMaxObserver
from ..parallel import (cross_entropy_loss, distillation_loss, make_eval_step,
                        make_train_step, qat_optimizer)
from ..utils import plan_mixed_precision, reestimate_batch_stats

__all__ = ["N_CLASSES", "SIZE", "EVAL_N", "EVAL_CHUNK", "BN_BATCHES", "T95",
           "grating_draws", "grating_images", "make_batch", "cosine_lr", "Recipe",
           "recipe", "recipe_names", "planned_recipe", "paired_delta", "summarize",
           "run_seed", "main"]

N_CLASSES = 36       # 5 degrees apart
SIZE = 32
EVAL_N = 20_000
EVAL_CHUNK = 2_000
BN_BATCHES = 400     # examples/recipe_sweep.py's --bn-batches
BASE_LR, WEIGHT_DECAY = 3e-3, 1e-4
WARM_BATCHES = 20    # recipe_sweep.py: the *_warm recipes' calibration batches
DISTILL_ALPHA, DISTILL_T = 0.5, 2.0  # recipe_sweep.py's distillation_loss arguments
MP_SCOUT = "combo1200_4"  # recipe_sweep.py: the mixed-precision recipes' scout
MP_BITS = (4, 8)
MP_PLAN_SEED = 424_242    # the plan's batch: make_batch(key(424242 + seed))
# two-sided t critical values at 95% for df = n - 1 (the JAX package's table)
T95 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571}
MODELS = {"resnet18": resnet18_cifar, "mobilenetv2": mobilenetv2_cifar}


def grating_draws(n: int, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The random inputs of ``n`` grating images, as ``make_batch`` draws
    them: labels, the orientation's standard-normal jitter, frequency in
    [2, 6), phase in [0, 2 pi), amplitude in [0.15, 1), the background
    gradient's (n, 2, 1, 1) slopes (0.5 x normal), the (n, 3, 1, 1) tint in
    [0.7, 1.3) and the (n, 3, 32, 32) standard-normal noise."""
    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device)

    return {"labels": torch.randint(0, N_CLASSES, (n,), generator=generator,
                                    device=device),
            "theta_noise": normal((n,)),
            "freq": uniform((n,), 2.0, 6.0),
            "phase": uniform((n,), 0.0, 2 * math.pi),
            "amp": uniform((n,), 0.15, 1.0),
            "gxy": 0.5 * normal((n, 2, 1, 1)),
            "tint": uniform((n, 3, 1, 1), 0.7, 1.3),
            "noise": normal((n, 3, SIZE, SIZE))}


def grating_images(d: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``make_batch``'s formula on the draws ``d``, in its order of
    operations: the (n, 3, 32, 32) f32 images."""
    ar = torch.arange(SIZE, device=d["freq"].device, dtype=torch.float32) / SIZE
    xx, yy = ar[None, :], ar[:, None]
    theta = d["labels"].to(torch.float32) * (math.pi / N_CLASSES) + 0.02 * d["theta_noise"]
    u = (torch.cos(theta)[:, None, None] * xx[None]
         + torch.sin(theta)[:, None, None] * yy[None])
    g = d["amp"][:, None, None] * torch.sin(
        2 * math.pi * d["freq"][:, None, None] * u + d["phase"][:, None, None])
    bg = d["gxy"][:, 0] * xx[None] + d["gxy"][:, 1] * yy[None]
    return (g + bg)[:, None] * d["tint"] + 1.15 * d["noise"]


def make_batch(n: int, generator: torch.Generator, device):
    """``n`` grating images (n, 3, 32, 32) and their int64 labels."""
    d = grating_draws(n, generator, device)
    return grating_images(d), d["labels"]


def cosine_lr(i: int, steps: int, base: float = BASE_LR) -> float:
    """optax's ``cosine_decay_schedule(base, steps)`` at update count ``i``."""
    return base * 0.5 * (1.0 + math.cos(math.pi * min(i, steps) / steps))


def default_tx(model, on_card: bool) -> torch.optim.Optimizer:
    """``recipe_sweep.py``'s ``default_tx``: AdamW (optax's default decay)
    over every parameter."""
    return torch.optim.AdamW(model.parameters(), lr=BASE_LR, weight_decay=WEIGHT_DECAY,
                             capturable=on_card)


def _adamw(on_card: bool):
    return lambda ps: torch.optim.AdamW(ps, lr=BASE_LR, weight_decay=WEIGHT_DECAY,
                                        capturable=on_card)


def sgdq_tx(model, on_card: bool) -> torch.optim.Optimizer:
    """``sgdq_tx``: the weights on AdamW, the qparams on SGD (momentum 0.9,
    the same cosine lr), through ``qat_optimizer``'s clip and scale floor."""
    return qat_optimizer(model, _adamw(on_card), lambda ps: torch.optim.SGD(
        ps, lr=BASE_LR, momentum=0.9, fused=on_card))


def adamq_tx(model, on_card: bool) -> torch.optim.Optimizer:
    """``adamq_tx``: the weights on AdamW, the qparams on Adam, guarded."""
    return qat_optimizer(model, _adamw(on_card), lambda ps: torch.optim.Adam(
        ps, lr=BASE_LR, capturable=on_card))


@dataclasses.dataclass(frozen=True)
class Recipe:
    """A recipe of ``recipe_sweep.py``: its qconfig, its optimizer
    (``optimizer(model, on_card)``), a function of the model run before
    training (``set_static_estimate``), its warm-start batch count, whether
    it distills from the seed's float model, and for a mixed-precision
    recipe the average weight bits its plan targets (its qconfig is then
    the uniform one the plan starts from; :func:`planned_recipe`)."""

    qconfig: QConfig
    optimizer: Callable = default_tx
    state_fn: Optional[Callable] = None
    warm_batches: int = 0
    distill: bool = False
    mp_target: Optional[float] = None


def _with_observer(qc: QConfig) -> QConfig:
    """A moving-average min/max observer on a learnable-mode activation
    quantizer, so the warm start's ``calibrate`` has something to drive."""
    return dataclasses.replace(qc, activation=dataclasses.replace(
        qc.activation, observer=MovingAverageMinMaxObserver()))


def _recipes() -> Dict[str, Recipe]:
    """``recipes()`` and ``recipes_w4a8()`` of ``recipe_sweep.py``
    (:125-250) by name."""
    def dq(wbits=8, window=20, **kw):
        return default_qconfig(wbits, 8, per_channel_weights=True, init_batches=window,
                               **kw)

    base = dq()
    combo = dq(window=100, reduce_range=False)
    learn = dq(window=100, init_mode="learnable")
    learn_full = dq(window=100, init_mode="learnable", reduce_range=False)
    no_dw_act = {"depthwise": dataclasses.replace(base, activation=None)}
    out = {
        "base": Recipe(base),
        "noact": Recipe(dataclasses.replace(base, activation=None)),
        "noweight": Recipe(dataclasses.replace(base, weight=None)),
        "learnable": Recipe(learn),
        "mse": Recipe(dq(act_observer="mse")),
        "histogram": Recipe(dq(act_observer="histogram")),
        "window100": Recipe(dq(window=100)),
        "full8": Recipe(dq(reduce_range=False)),
        "dwfloat": Recipe(base.with_overrides(no_dw_act)),
        "combo": Recipe(combo),
        "combo_dw": Recipe(combo.with_overrides(
            {"depthwise": dataclasses.replace(combo, activation=None)})),
        "window400": Recipe(dq(window=400)),
        "combo400": Recipe(dq(window=400, reduce_range=False)),
        "sgdq": Recipe(base, sgdq_tx),
        "learnable_sgdq": Recipe(learn, sgdq_tx),
        "combo_sgdq": Recipe(combo, sgdq_tx),
        "combo400_sgdq": Recipe(dq(window=400, reduce_range=False), sgdq_tx),
        "window1200": Recipe(dq(window=1200)),
        "combo1200": Recipe(dq(window=1200, reduce_range=False)),
        "static": Recipe(base, default_tx, set_static_estimate),
        "static_full8": Recipe(dq(reduce_range=False), default_tx, set_static_estimate),
        "learnable_clip": Recipe(learn, sgdq_tx),
        "learnable_adamq": Recipe(learn, adamq_tx),
        "combo_learnable": Recipe(learn_full, adamq_tx),
        "percentile1200": Recipe(dq(window=1200, act_observer="percentile")),
        "learnable_warm": Recipe(_with_observer(learn), sgdq_tx,
                                 warm_batches=WARM_BATCHES),
        "combo_learnable_warm": Recipe(_with_observer(learn_full), sgdq_tx,
                                       warm_batches=WARM_BATCHES),
        # recipes_w4a8
        "base4": Recipe(dq(4)),
        "full8_4": Recipe(dq(4, reduce_range=False)),
        "window1200_4": Recipe(dq(4, window=1200)),
        "combo1200_4": Recipe(dq(4, window=1200, reduce_range=False)),
        "learnable4": Recipe(dq(4, window=100, init_mode="learnable"), adamq_tx),
        # the float teacher's KL term on combo1200, static, percentile1200 and
        # combo1200_4
        "distill": Recipe(dq(window=1200, reduce_range=False), distill=True),
        "distill_static": Recipe(base, default_tx, set_static_estimate, distill=True),
        "distill_percentile": Recipe(dq(window=1200, act_observer="percentile"),
                                     distill=True),
        "distill4": Recipe(dq(4, window=1200, reduce_range=False), distill=True),
    }
    # planned mixed precision on a combo1200_4 scout, then trained fresh
    for name, target in (("mp4_48", 4.8), ("mp4_56", 5.6)):
        out[name] = Recipe(dq(4, window=1200, reduce_range=False), mp_target=target)
    return out


def recipe_names() -> Sequence[str]:
    """Every recipe name ``recipe`` knows, ``float`` first."""
    return ["float"] + list(_recipes())


def recipe(name: str) -> Recipe:
    """``float`` (no quantizer, ``default_tx``), or a recipe of
    ``examples/recipe_sweep.py``'s ``recipes()`` and ``recipes_w4a8()``
    (:125-250)."""
    if name == "float":
        return Recipe(QConfig())
    table = _recipes()
    if name not in table:
        raise ValueError(f"unknown recipe {name!r}; one of {', '.join(recipe_names())}")
    return table[name]


def planned_recipe(rec: Recipe, scout: torch.nn.Module, seed: int, batch: int,
                   device) -> tuple:
    """A mixed-precision recipe made concrete (``recipe_sweep.py``:449-476):
    ``plan_mixed_precision`` over the trained ``scout`` (weights at 4 or 8
    bits, ``rec.mp_target`` average bits) on a batch of ``batch`` images
    drawn from 424,242 + ``seed``.  Returns the recipe under the planned
    qconfig and its row's ``avg_bits``, ``n_int8`` and ``n_scopes``."""
    x, y = make_batch(batch, _generator(MP_PLAN_SEED + seed, device), device)
    plan = plan_mixed_precision(scout, {"image": x, "label": y}, bit_options=MP_BITS,
                                target_avg_bits=rec.mp_target, input_key="image",
                                verify=False)
    extra = {"avg_bits": round(plan["avg_bits"], 3),
             "n_int8": sum(1 for b in plan["assignment"].values() if b == 8),
             "n_scopes": len(plan["assignment"])}
    return dataclasses.replace(rec, qconfig=plan["qconfig"]), extra


def paired_delta(pred_a: np.ndarray, pred_b: np.ndarray, labels: np.ndarray):
    """top1(a) - top1(b) on the same samples, and its paired sigma
    ``sqrt(n01 + n10 - (n01 - n10)^2 / n) / n`` over the disagreements."""
    a = pred_a == labels
    b = pred_b == labels
    n = labels.size
    n01 = int(np.sum(a & ~b))
    n10 = int(np.sum(~a & b))
    delta = (n01 - n10) / n
    sigma = float(np.sqrt(max(n01 + n10 - (n01 - n10) ** 2 / n, 0))) / n
    return delta, sigma


def summarize(results: Dict, name: str, seeds: Sequence[int],
              cfgs: Sequence[str] = ("w8a8", "w4a8"),
              suffixes: Sequence[str] = ("", "_served")) -> None:
    """Across-seed mean and 95% CI half-width of each config's paired delta
    against float, with the BASELINE bar's two flags, written into
    ``results[f"{name}/summary/{cfg}{suffix}"]`` as the JAX package does."""
    for cfg in cfgs:
        for suffix in suffixes:
            key = cfg + suffix
            deltas = [results[f"{name}/seed{s}/paired"][key]["delta"] for s in seeds
                      if key in results[f"{name}/seed{s}/paired"]]
            if not deltas:
                continue
            m = float(np.mean(deltas))
            if len(deltas) > 1:
                sd = float(np.std(deltas, ddof=1))
                half = T95.get(len(deltas) - 1, 2.0) * sd / np.sqrt(len(deltas))
            else:
                sd, half = 0.0, float("nan")
            results[f"{name}/summary/{key}"] = {
                "mean_delta_vs_float": round(m, 5),
                "ci95_half_width": round(half, 5),
                "per_seed_deltas": [round(d, 5) for d in deltas],
                # the bar guards against degradation: the CI's lower edge
                # must not cross -0.1%
                "no_degradation_beyond_0.1pct": bool(m - half >= -0.001),
                "within_0.1pct_band": bool(abs(m) + half <= 0.001),
            }


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def train(model_fn: Callable, rec: Recipe, steps: int, batch: int, seed: int,
          device, teacher: Optional[torch.nn.Module] = None) -> Dict:
    """One recipe's training run (a ``distill`` recipe against ``teacher``):
    returns the model and its optimizer, the last loss, the lr written
    before each step, and the seconds and images/s of the steps."""
    if rec.distill and teacher is None:
        raise ValueError("a distillation recipe needs the float teacher")
    model = model_fn(rec.qconfig)
    x0, _ = make_batch(batch, _generator(seed + 999, device), device)
    model.eval()
    with torch.no_grad():  # flax's init: one eval forward feeds the observers
        model(x0)
    if rec.state_fn is not None:
        rec.state_fn(model)
    if rec.warm_batches:
        # statistics first: the observers calibrate the ranges, then the
        # learnable window refines them
        wgen = _generator(555_000 + seed, device)
        calibrate(model, [make_batch(batch, wgen, device)[0]
                          for _ in range(rec.warm_batches)])
        map_quant_state(model, lambda qs: {**qs, "learning_enabled": True,
                                           "observer_enabled": False})
    on_card = torch.device(device).type == "cuda"
    opt = rec.optimizer(model, on_card)
    loss_fn = (distillation_loss(teacher, alpha=DISTILL_ALPHA, temperature=DISTILL_T)
               if rec.distill else cross_entropy_loss)
    step = make_train_step(model, opt, loss_fn=loss_fn, jit=True)
    gen = _generator(seed, device)
    lrs, loss = [], None
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        x, y = make_batch(batch, gen, device)
        lr = cosine_lr(i, steps)
        for group in opt.param_groups:
            group["lr"] = lr
        lrs.append(lr)
        loss = step({"image": x, "label": y})["loss"]
    loss = float(loss)
    secs = time.perf_counter() - t0
    return {"model": model, "optimizer": opt, "loss": loss, "lrs": lrs,
            "train_s": secs, "images_per_s": steps * batch / secs}


def eval_batches(seed: int, device, n: int = EVAL_N,
                 chunk: int = EVAL_CHUNK) -> Iterator:
    """The seed's fixed eval set, chunk by chunk (each chunk from its own
    generator, so every config sees the same images)."""
    for i in range(n // chunk):
        yield make_batch(chunk, _generator(1_000_000 + 1000 * seed + i, device), device)


@torch.no_grad()
def predictions(fn: Callable, seed: int, device, n: int = EVAL_N,
                chunk: int = EVAL_CHUNK):
    """argmax predictions of ``fn(images)`` and the labels over the eval set."""
    preds, labels = [], []
    for x, y in eval_batches(seed, device, n, chunk):
        preds.append(fn(x).argmax(-1).cpu().numpy())
        labels.append(y.cpu().numpy())
    return np.concatenate(preds), np.concatenate(labels)


def run_seed(model_name: str, recipe_names, seed: int, results: Dict, *,
             steps: int = 1500, batch: int = 128, device=None, eval_n: int = EVAL_N,
             eval_chunk: int = EVAL_CHUNK, bn_batches: int = BN_BATCHES,
             log: Callable = lambda line: print(line, flush=True)) -> Dict:
    """Train float once and each of ``recipe_names`` (a name, a
    comma-separated string or a sequence) on one data seed, evaluate each on
    the seed's fixed eval set (a QAT model raw, served and after BatchNorm
    re-estimation) and record the rows and the paired deltas against the
    seed's float model in ``results``; returns the seed's record."""
    names = recipe_names.split(",") if isinstance(recipe_names, str) else list(recipe_names)
    dev = resolve_device(device)
    model_fn = MODELS[model_name]
    prefix = f"{model_name}/seed{seed}"
    preds = {}
    labels = None
    teacher = None
    paired = results.setdefault(f"{prefix}/paired", {})
    scout = None  # the mixed-precision recipes' scout, trained once a seed
    for cfg in ["float"] + names:
        rec = recipe(cfg)
        extra = {}
        if rec.mp_target is not None:
            if scout is None:
                srun = train(lambda q: model_fn(N_CLASSES, q, device=dev, seed=0),
                             recipe(MP_SCOUT), steps, batch, seed, dev)
                scout = srun["model"]
                log(json.dumps({"row": f"{prefix}/{MP_SCOUT} (scout)",
                                "train_loss": round(srun["loss"], 4),
                                "train_s": round(srun["train_s"], 1)}))
                del srun
            rec, extra = planned_recipe(rec, scout, seed, batch, dev)
        qc = rec.qconfig
        run = train(lambda q: model_fn(N_CLASSES, q, device=dev, seed=0), rec,
                    steps, batch, seed, dev, teacher)
        model = run["model"]
        evaluate = make_eval_step(model)
        p, labels = predictions(lambda x: evaluate({"image": x}), seed, dev, eval_n,
                                eval_chunk)
        preds[cfg] = p
        row = {"train_loss": round(run["loss"], 4), "top1": round(float((p == labels).mean()), 5),
               "train_s": round(run["train_s"], 1),
               "images_per_s": round(run["images_per_s"], 1), "steps_ran": steps, **extra}
        if qc.weight is not None:
            # served: the raw trained variables through convert (load_variables)
            smodel = model_fn(N_CLASSES, qc.for_serving("static"), device=dev)
            interop.load_variables(smodel, interop.qat_variables(model))
            smodel.eval()
            preds[cfg + "_served"], _ = predictions(smodel, seed, dev, eval_n, eval_chunk)
            row["top1_served"] = round(float((preds[cfg + "_served"] == labels).mean()), 5)
        if qc.weight is not None or qc.activation is not None:
            # BatchNorm re-estimation over bn_batches calibration batches
            bgen = _generator(777_000 + seed, dev)
            reestimate_batch_stats(model, (make_batch(batch, bgen, dev)[0]
                                           for _ in range(bn_batches)))
            preds[cfg + "_bnreest"], _ = predictions(lambda x: evaluate({"image": x}),
                                                     seed, dev, eval_n, eval_chunk)
            row["top1_bnreest"] = round(float((preds[cfg + "_bnreest"] == labels).mean()), 5)
            row["bn_batches"] = bn_batches
        results[f"{prefix}/{cfg}"] = row
        log(json.dumps({"row": f"{prefix}/{cfg}", **row}))
        if cfg == "float" and any(recipe(n).distill for n in names):
            teacher = model
        del model, run
        if cfg == "float":
            continue
        for key in (cfg, cfg + "_bnreest", cfg + "_served"):
            if key in preds:
                d, sg = paired_delta(preds.pop(key), preds["float"], labels)
                paired[key] = {"delta": round(d, 5), "paired_sigma": round(sg, 6)}
    return {k: v for k, v in results.items() if k.startswith(prefix + "/")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", default="mobilenetv2",
                    help="comma-separated: resnet18, mobilenetv2")
    ap.add_argument("--recipe", default="combo1200",
                    help="comma-separated recipes of examples/recipe_sweep.py, e.g. "
                         "combo1200,mse,histogram,percentile1200,static,sgdq")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--seed-start", type=int, default=1)
    ap.add_argument("--bn-batches", type=int, default=BN_BATCHES)
    ap.add_argument("--out", default=None, help="also write the whole record here (JSON)")
    args = ap.parse_args(argv)
    names = args.recipe.split(",")
    for name in names:  # an unknown name fails before any training
        recipe(name)
    if not torch.cuda.is_available():
        print("accuracy_parity: no CUDA device; the protocol runs on the card",
              flush=True)
        return 2
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {
        "task": (f"procedural {N_CLASSES}-orientation grating classification (5 deg "
                 "apart), 32x32x3, drawn on the device from torch.Generator"),
        "train": (f"{args.steps} steps x B{args.batch}, each recipe's optimizer "
                  f"(AdamW wd {WEIGHT_DECAY}, or the sgdq/adamq partitions) under the "
                  f"cosine {BASE_LR}, make_train_step(jit=True)"),
        "eval": (f"{EVAL_N} held-out samples a seed, the same for every config; "
                 f"BatchNorm re-estimation over {args.bn_batches} batches"),
        "recipe": args.recipe, "card": card, "torch": torch.__version__,
        "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps({"card": card}), flush=True)
    seeds = list(range(args.seed_start, args.seed_start + args.seeds))
    for name in args.models.split(","):
        for seed in seeds:
            rec = run_seed(name, names, seed, results, steps=args.steps,
                           batch=args.batch, device="cuda", bn_batches=args.bn_batches)
            print(json.dumps({"seed": seed, "model": name, **rec}), flush=True)
            if args.out:
                with open(args.out, "w") as f:  # after each seed
                    json.dump(results, f, indent=1)
        summarize(results, name, seeds, cfgs=names,
                  suffixes=("", "_bnreest", "_served"))
        print(json.dumps({k: v for k, v in results.items()
                          if k.startswith(f"{name}/summary/")}), flush=True)
        if args.out:
            with open(args.out, "w") as f:  # after each model
                json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
