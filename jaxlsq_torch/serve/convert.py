"""QAT -> serving conversion (port of ``jaxlsq/serve/convert.py``).

:func:`convert` walks a QAT variables tree (nested dicts of tensors with the
JAX package's collection and layer names), folds each weight quantizer's
(scale, shift) into (scale, zero_point), quantizes + packs the kernels, and
freezes each activation quantizer's qparams; ``weight_group_size`` packs the
int4 dense kernels group-wise instead.  Tensor-parallel placement
(``shard_packed``/``shard_converted``) comes with the multi-device slice.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core.golden import clamp_scale
from ..core.spec import QuantSpec
from ..observers.quantizer import convert_shift_to_zp
from .pack import quantize_weight, quantize_weight_grouped

__all__ = ["convert", "serving_bits"]


def serving_bits(spec: QuantSpec) -> int:
    """Carrier width for a weight spec: int4 only when the quant range fits
    the signed int4 carrier [-8, 7], else int8."""
    if -8 <= spec.quant_min and spec.quant_max <= 7:
        return 4
    return 8


def _act_qparams(qp: Dict[str, torch.Tensor], spec: QuantSpec
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Freeze an activation quantizer: ``max(|s|, eps)`` + shift->zp fold."""
    scale = clamp_scale(qp["scale"])
    zp = convert_shift_to_zp(qp["shift"], scale, spec)
    return scale, zp


def _weight_axis_for(kernel: torch.Tensor) -> int:
    """Per-channel axis by kernel layout: dense (K, N) -> 1; conv -> ndim-1;
    stacked experts (E, K, N) -> 0."""
    if kernel.dim() == 3:
        return 0
    return kernel.dim() - 1


def _tensors(tree):
    """``tree`` with its numpy leaves as tensors (``interop.qat_variables``
    gives numpy arrays, as the JAX package's trees hold)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def convert(variables: Dict[str, Any], qconfig, *,
            weight_group_size: int = None) -> Dict[str, Any]:
    """Convert QAT variables ('params', 'qparams', optional 'quant_state')
    into serving variables: packed kernels in a 'quantized' collection,
    packed kernels dropped from 'params', 'qparams'/'quant_state' dropped.
    The embedding table is always packed at 8 bits (a row gather needs
    whole bytes).

    ``weight_group_size``: every 2-D ``kernel`` whose serving carrier is int4
    and whose K divides by it is re-quantized group-wise
    (:func:`quantize_weight_grouped`); everything else keeps the per-channel
    fold of its learned qparams."""
    if weight_group_size is not None and weight_group_size < 1:
        raise ValueError(f"weight_group_size must be >= 1, got {weight_group_size}")
    variables = _tensors(variables)
    params = variables["params"]
    qparams = variables.get("qparams", {})
    quant_state = variables.get("quant_state", {})

    def walk(p_tree, q_tree, s_tree, path=()):
        if not isinstance(p_tree, dict):
            return p_tree, None
        wname = next((k for k in ("kernel", "embedding") if k in p_tree), None)
        has_wq = (isinstance(q_tree, dict) and "weight_fq" in q_tree
                  and wname is not None)
        if has_wq:
            qcfg = qconfig.resolve(path)
            kernel = p_tree[wname]
            if isinstance(s_tree, dict) and "dg_flat" in s_tree:
                kernel = kernel.reshape(tuple(int(d) for d in s_tree["dg_flat"]))
            axis = 0 if wname == "embedding" else _weight_axis_for(kernel)
            wspec = (qcfg.weight.spec.replace(axis=axis)
                     if qcfg.weight.spec.per_channel else qcfg.weight.spec)
            wqp = q_tree["weight_fq"]["qp"]
            bits = 8 if wname == "embedding" else serving_bits(wspec)
            if (weight_group_size is not None and bits == 4
                    and wname == "kernel" and kernel.dim() == 2
                    and kernel.shape[0] % weight_group_size == 0):
                packed = quantize_weight_grouped(
                    kernel, group_size=weight_group_size, bits=4)
            else:
                packed = quantize_weight(kernel, wqp["scale"], wqp["shift"],
                                         wspec, bits=bits)
            quantized: Dict[str, Any] = {wname: packed}
            if "act_fq" in q_tree and qcfg.activation is not None:
                ascale, azp = _act_qparams(q_tree["act_fq"]["qp"],
                                           qcfg.activation.spec)
                quantized["act_scale"] = ascale
                quantized["act_zp"] = azp
            new_p = {k: v for k, v in p_tree.items() if k != wname}
            return new_p, quantized
        new_p, new_q = {}, {}
        for k, v in p_tree.items():
            sub_q = q_tree.get(k, {}) if isinstance(q_tree, dict) else {}
            sub_s = s_tree.get(k, {}) if isinstance(s_tree, dict) else {}
            np_, nq_ = walk(v, sub_q, sub_s, path + (k,))
            if not (isinstance(np_, dict) and not np_):
                new_p[k] = np_
            if nq_:
                new_q[k] = nq_
        return new_p, new_q

    new_params, quantized = walk(params, qparams, quant_state)
    out = {"params": new_params, "quantized": quantized or {}}
    for k, v in variables.items():
        if k not in ("params", "qparams", "quant_state", "quantized", "losses"):
            out[k] = v
    return out
