"""Automatic mixed-precision planning: sensitivity -> per-layer weight bit
widths (port of ``jaxlsq/utils/mixed_precision.py``).

``plan_mixed_precision`` measures, for every quantized layer and every
candidate weight bit width, the eval-loss damage of quantizing ONLY that
layer (the quant-only protocol of ``utils.sensitivity``), then greedily
buys the promotions with the best damage reduction per extra weight bit
under an average-bits budget.  The result is a ``QConfig.with_overrides``
config (longest pattern first) for a mixed-precision QAT run and for
``serve.convert``, which packs each layer at its own carrier width.

Cross-bit evaluation keeps the learned range: a layer trained at ``b0``
bits has clip range ``scale_b0 * quant_max_b0``; at ``b`` bits the scale
becomes ``scale_b0 * quant_max_b0 / quant_max_b``.  The JAX package swaps
the model's qconfig (``dataclasses.replace``); a torch module holds its
quantizers' specs itself, so width ``b`` is evaluated on a deep copy of the
model whose every weight quantizer takes the requantized spec and the
rescaled scale.  The model itself is left as it was.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.spec import QuantSpec
from ..models.layers import FakeQuantize
from ..models.toggles import disable_observer
from .sensitivity import (_default_loss, eval_loss_fn, quant_flags_restored,
                          quantizer_scopes, set_fake_quant_by_scope)

__all__ = ["plan_mixed_precision", "requantize_qconfig", "format_plan"]

Scope = Tuple[str, ...]


def requantize_qconfig(qconfig, weight_bits: int):
    """``qconfig`` with its WEIGHT spec rebuilt at ``weight_bits`` (the same
    signedness, symmetry and per-channel layout; a narrowed range stays
    narrowed by one bit).  Activations are untouched."""
    if qconfig.weight is None:
        raise ValueError("qconfig has no weight quantizer to requantize")
    s = qconfig.weight.spec
    narrowed = s.quant_max < s.type_max or s.quant_min > s.type_min
    new_spec = QuantSpec.make(
        weight_bits,
        signed=s.type_min < 0,
        symmetric=s.symmetric,
        per_channel=s.per_channel,
        axis=s.axis,
        narrow_to_bits=weight_bits - 1 if narrowed else None,
        use_grad_scaling=s.use_grad_scaling,
        grad_scaler=s.grad_scaler,
    )
    return dataclasses.replace(
        qconfig, weight=dataclasses.replace(qconfig.weight, spec=new_spec))


def _weight_numel(model: nn.Module, scope: Scope) -> int:
    """Packed-weight parameter count under ``scope``: the JAX package's
    ``kernel``/``embedding`` leaves (the tensors ``serve.convert`` packs;
    biases stay float and do not count against the budget)."""
    from ..interop import _FLOAT_LAYERS, _KERNEL_LAYERS, _weight_views

    try:
        root = model.get_submodule(".".join(scope))
    except AttributeError:
        return 0
    return sum(_weight_views(m)[0].numel() for m in root.modules()
               if (isinstance(m, _KERNEL_LAYERS) and getattr(m, "qat", True))
               or type(m) in _FLOAT_LAYERS)


def _weight_quantizers(model: nn.Module):
    for name, m in model.named_modules():
        path = tuple(name.split("."))
        if isinstance(m, FakeQuantize) and path[-1] == "weight_fq":
            yield path[:-1], m


@torch.no_grad()
def _requantized_copy(model: nn.Module, spec_for_scope: Callable,
                      factor_for_scope: Callable) -> nn.Module:
    """A deep copy of ``model`` whose weight quantizer of each layer takes
    the weight spec ``spec_for_scope(layer path)`` (its own axis kept) and
    its scale times ``factor_for_scope(layer path)``, the learned-range
    factor (weight quantizers are symmetric: the shift stays)."""
    out = copy.deepcopy(model)
    for scope, fq in _weight_quantizers(out):
        spec = spec_for_scope(scope)
        fq.cfg = dataclasses.replace(fq.cfg, spec=spec.replace(axis=fq.cfg.spec.axis))
        factor = float(factor_for_scope(scope))
        if factor != 1.0:
            fq.scale.mul_(torch.tensor(factor, dtype=torch.float32, device=fq.scale.device))
    return out


def plan_mixed_precision(model: nn.Module, batch: Dict, *,
                         bit_options: Sequence[int] = (4, 8),
                         target_avg_bits: float = 6.0,
                         loss_fn: Optional[Callable] = None,
                         input_key: str = "input",
                         verify: bool = True) -> Dict[str, Any]:
    """Measure per-layer damage at each candidate weight bit width and
    assign bits under an average-weight-bits budget.

    ``model``: the trained QAT model, carrying its uniform config as
    ``model.qconfig``.  ``batch`` holds ``input_key`` and whatever
    ``loss_fn`` reads (default: integer-label cross entropy on
    ``batch['label']``).  ``bit_options``: candidate WEIGHT widths, e.g.
    ``(4, 8)``; activations keep the root config's spec.
    ``target_avg_bits``: the numel-weighted mean weight bits must not
    exceed it.  ``verify``: also evaluate the planned mixed model.

    Returns ``assignment`` ({scope: bits}), ``qconfig`` (the
    ``with_overrides`` config: train with it, then ``serve.convert`` packs
    mixed carriers), ``avg_bits``, ``target_avg_bits``, ``baseline_float``,
    ``uniform`` ({bits: all-quant loss}), per-layer ``rows`` and, with
    ``verify``, ``planned_quant_loss`` and ``planned_model`` (the deep copy
    with the planned specs and rescaled scales, its observers off)::

        from jaxlsq_torch.utils import format_plan, plan_mixed_precision

        plan = plan_mixed_precision(model, {"image": x, "label": y},
                                    bit_options=(4, 8), target_avg_bits=4.8,
                                    input_key="image")
        print(format_plan(plan))
        mixed = mobilenetv2_cifar(36, plan["qconfig"])   # train this fresh
    """
    loss_fn = _default_loss(loss_fn)
    bits = sorted(set(int(b) for b in bit_options))
    if len(bits) < 2:
        raise ValueError("need at least two bit_options to plan a mix")
    root_qc = getattr(model, "qconfig", None)
    if root_qc is None or root_qc.weight is None:
        raise ValueError("model.qconfig must carry a weight quantizer")
    if root_qc.overrides:
        raise ValueError("plan from a uniform root qconfig (overrides set)")
    # layer granularity only: overrides resolve against layer paths
    scopes = quantizer_scopes(model, "layer")
    if not scopes:
        raise ValueError("no quantizers found in the model")
    numel = {s: _weight_numel(model, s) for s in scopes}
    # scopes with no packed weight have no byte cost: they keep the root width
    weighted = [s for s in scopes if numel[s] > 0]
    if not weighted:
        raise ValueError("no weight-carrying quantized scopes found")
    total = sum(numel[s] for s in weighted)

    def evaluator(m: nn.Module) -> Callable:
        disable_observer(m)  # trained qparams stay frozen (sensitivity.py)
        evaluate = eval_loss_fn(m, batch, loss_fn, input_key)

        def run(enabled):
            set_fake_quant_by_scope(m, enabled)
            return evaluate()

        return run

    root_qmax = root_qc.weight.spec.quant_max
    damage: Dict[int, Dict[Scope, float]] = {}
    uniform: Dict[int, float] = {}
    baseline_float = None
    for b in bits:
        qc_b = requantize_qconfig(root_qc, b)
        factor = root_qmax / qc_b.weight.spec.quant_max
        run = evaluator(_requantized_copy(model, lambda s: qc_b.weight.spec,
                                          lambda s: factor))
        if baseline_float is None:
            baseline_float = run([])
        uniform[b] = run(scopes)
        damage[b] = {s: run([s]) - baseline_float for s in weighted}

    # Greedy promotion: everyone starts at the cheapest width; repeatedly buy
    # the promotion with the best damage reduction per extra bit·numel that
    # still fits the budget.
    assignment = {s: bits[0] for s in weighted}
    budget = target_avg_bits * total
    spent = bits[0] * total
    if spent > budget:
        raise ValueError(f"target_avg_bits={target_avg_bits} is below the smallest "
                         f"option {bits[0]}")
    while True:
        best, best_gain = None, -float("inf")
        for s in weighted:
            i = bits.index(assignment[s])
            if i + 1 == len(bits):
                continue
            nb = bits[i + 1]
            extra = (nb - bits[i]) * numel[s]
            if spent + extra > budget:
                continue
            gain = (damage[bits[i]][s] - damage[nb][s]) / extra
            if gain > best_gain:
                best, best_gain = s, gain
        if best is None:
            break
        spent += (bits[bits.index(assignment[best]) + 1] - assignment[best]) * numel[best]
        assignment[best] = bits[bits.index(assignment[best]) + 1]

    # Longest pattern first: with_overrides matches the first substring, so
    # a nested name must be shadowed by its longer sibling coming earlier.
    per_bits_qc = {b: requantize_qconfig(root_qc, b) for b in bits}
    mapping = {"/".join(s): per_bits_qc[assignment[s]]
               for s in sorted(weighted, key=lambda s: -len("/".join(s)))}
    planned_qc = root_qc.with_overrides(mapping)

    result: Dict[str, Any] = {
        "assignment": {"/".join(s): assignment[s] for s in weighted},
        "qconfig": planned_qc,
        "avg_bits": spent / total,
        "target_avg_bits": float(target_avg_bits),
        "baseline_float": baseline_float,
        "uniform": uniform,
        "rows": [
            {"scope": "/".join(s), "numel": numel[s], "bits": assignment[s],
             **{f"damage_{b}b": damage[b][s] for b in bits}}
            for s in sorted(weighted, key=lambda s: -damage[bits[0]][s])
        ],
    }
    if verify:
        factors = {s: root_qmax / per_bits_qc[assignment[s]].weight.spec.quant_max
                   for s in weighted}
        planned = _requantized_copy(model, lambda s: planned_qc.resolve(s).weight.spec,
                                    lambda s: factors.get(s, 1.0))
        planned.qconfig = planned_qc
        with quant_flags_restored(planned):
            result["planned_quant_loss"] = evaluator(planned)(scopes)
        disable_observer(planned)
        result["planned_model"] = planned
    return result


def format_plan(plan: Dict[str, Any]) -> str:
    lines = [
        f"avg weight bits {plan['avg_bits']:.2f} "
        f"(target {plan['target_avg_bits']:.2f})   float loss "
        f"{plan['baseline_float']:.6f}",
        "uniform: " + "   ".join(f"{b}b {v:.6f}" for b, v in sorted(plan["uniform"].items())),
    ]
    if "planned_quant_loss" in plan:
        lines.append(f"planned mixed loss {plan['planned_quant_loss']:.6f}")
    hdr = f"{'scope':<40} {'bits':>5} {'numel':>10}"
    bcols = sorted(int(k.split('_')[1][:-1]) for k in plan["rows"][0] if k.startswith("damage_"))
    hdr += "".join(f" {'Δ@' + str(b) + 'b':>12}" for b in bcols)
    lines.append(hdr)
    for r in plan["rows"]:
        row = f"{r['scope']:<40} {r['bits']:>5} {r['numel']:>10}"
        row += "".join(f" {r[f'damage_{b}b']:>12.6f}" for b in bcols)
        lines.append(row)
    return "\n".join(lines)
