"""Per-layer quantization sensitivity (port of ``jaxlsq/utils/sensitivity.py``).

For every quantized scope of a model, the eval-loss damage of (a) quantizing
ONLY that scope ("quant-only": its isolated contribution) and (b)
quantizing everything EXCEPT it ("leave-one-out": how much restoring it to
float recovers).  The sensitive scopes are the ones to keep at higher
precision (``utils.mixed_precision`` plans that).

A scope is the JAX package's path tuple: a quantizer's module path split
at its dots (``('blocks_0', 'expand', 'act_fq')``), its layer the path
without the last name; a scope covers every quantizer under it (prefix
match).  Scopes come in module order.  The JAX package returns new
variables trees; here :func:`set_fake_quant_by_scope` writes the
``fake_quant_enabled`` flags in place (``models.toggles.map_quant_state``)
and :func:`sensitivity_report` restores every quantizer's counters and
flags, and ``model.training``, when it returns or raises.  Each of its
2·L + 2 evaluations is an eager eval-mode forward under ``no_grad`` that
keeps no quantizer state (the JAX package runs one compiled program).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.layers import FakeQuantize, quant_state_frozen, refresh_host_state
from ..models.toggles import disable_observer, map_quant_state
from ..observers.quantizer import STATE_FIELDS

__all__ = ["quantizer_scopes", "set_fake_quant_by_scope", "sensitivity_report",
           "format_sensitivity"]

Scope = Tuple[str, ...]


def _quantizers(model: nn.Module):
    return [(tuple(name.split(".")), m) for name, m in model.named_modules()
            if isinstance(m, FakeQuantize)]


def quantizer_scopes(model: nn.Module, granularity: str = "layer") -> List[Scope]:
    """The quantized scopes of ``model``: ``'layer'`` groups a layer's
    weight and activation quantizers into one scope (the layer's path, e.g.
    ``('blocks_0', 'mlp_up')``), ``'quantizer'`` lists each quantizer
    (``(..., 'weight_fq')``)."""
    if granularity not in ("layer", "quantizer"):
        raise ValueError("granularity must be 'layer' or 'quantizer'")
    found: List[Scope] = []
    for path, _ in _quantizers(model):
        scope = path if granularity == "quantizer" else path[:-1]
        if scope not in found:
            found.append(scope)
    return found


def set_fake_quant_by_scope(model: nn.Module, enabled_scopes: Sequence[Scope]) -> nn.Module:
    """``fake_quant_enabled`` True exactly for the quantizers under one of
    ``enabled_scopes`` (prefix match) and False elsewhere, written in place;
    returns ``model``."""
    scopes = [tuple(s) for s in enabled_scopes]
    for path, fq in _quantizers(model):
        on = any(path[:len(s)] == s for s in scopes)
        map_quant_state(fq, lambda qs, on=on: {**qs, "fake_quant_enabled": on})
    return model


@contextlib.contextmanager
def quant_flags_restored(model: nn.Module):
    """On exit (a return or an exception), every quantizer's counters and
    flags are what they were on entry, bit for bit, and ``model.training``
    too."""
    fqs = [m for _, m in _quantizers(model)]
    saved = [[getattr(m, f).clone() for f in STATE_FIELDS] for m in fqs]
    training = model.training
    try:
        yield
    finally:
        with torch.no_grad():
            for m, vals in zip(fqs, saved):
                for f, v in zip(STATE_FIELDS, vals):
                    getattr(m, f).copy_(v)
        model.train(training)


def eval_loss_fn(model: nn.Module, batch: Dict, loss_fn: Callable,
                 input_key: str) -> Callable[[], float]:
    """``() -> float``: the eval-mode loss of ``model`` on ``batch``, with no
    gradient and no quantizer state kept (the JAX package's apply with the
    collections other than ``params`` mutable and dropped)."""
    fqs = [m for _, m in _quantizers(model)]

    def run() -> float:
        model.eval()
        refresh_host_state(fqs)
        with torch.no_grad(), quant_state_frozen(fqs):
            return float(loss_fn(model(batch[input_key]), batch))

    return run


def _default_loss(loss_fn: Optional[Callable]) -> Callable:
    if loss_fn is not None:
        return loss_fn
    from ..parallel.train import cross_entropy_loss

    return cross_entropy_loss


def sensitivity_report(model: nn.Module, batch: Dict, *, loss_fn: Optional[Callable] = None,
                       input_key: str = "input",
                       granularity: str = "layer") -> Dict[str, Any]:
    """Per-scope quantization sensitivity of the trained ``model`` on one
    eval batch.

    ``batch`` holds ``input_key`` and whatever ``loss_fn`` reads;
    ``loss_fn(logits, batch) -> scalar`` defaults to integer-label cross
    entropy on ``batch['label']``.  The observers are off during the
    evaluations (the trained qparams are evaluated, not recalibrated); every
    flag is restored after.  Returns ``{"baseline_float",
    "baseline_quant", "rows"}``, each row ``{scope, quant_only,
    quant_only_delta, leave_one_out, leave_one_out_recovery}``, most
    sensitive first (by ``quant_only_delta``)::

        from jaxlsq_torch.utils import format_sensitivity, sensitivity_report

        batch = {"image": x_eval, "label": y_eval}
        report = sensitivity_report(model, batch, input_key="image")
        print(format_sensitivity(report))
    """
    loss_fn = _default_loss(loss_fn)
    scopes = quantizer_scopes(model, granularity)
    if not scopes:
        raise ValueError("no quantizers found in the model")
    with quant_flags_restored(model):
        # the trained qparams, not an observer's recalibration
        disable_observer(model)
        evaluate = eval_loss_fn(model, batch, loss_fn, input_key)

        def run(enabled):
            set_fake_quant_by_scope(model, enabled)
            return evaluate()

        baseline_float = run([])
        baseline_quant = run(scopes)
        rows = []
        for s in scopes:
            only = run([s])
            loo = run([t for t in scopes if t != s])
            rows.append({
                "scope": "/".join(s) or "<root>",
                "quant_only": only,
                "quant_only_delta": only - baseline_float,
                "leave_one_out": loo,
                "leave_one_out_recovery": baseline_quant - loo,
            })
    rows.sort(key=lambda r: r["quant_only_delta"], reverse=True)
    return {"baseline_float": baseline_float, "baseline_quant": baseline_quant,
            "rows": rows}


def format_sensitivity(report: Dict[str, Any]) -> str:
    lines = [
        f"float loss {report['baseline_float']:.6f}   "
        f"all-quant loss {report['baseline_quant']:.6f}",
        f"{'scope':<40} {'quant-only Δ':>14} {'leave-1-out recovery':>22}",
    ]
    for r in report["rows"]:
        lines.append(f"{r['scope']:<40} {r['quant_only_delta']:>14.6f} "
                     f"{r['leave_one_out_recovery']:>22.6f}")
    return "\n".join(lines)
