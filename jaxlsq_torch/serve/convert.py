"""QAT -> serving conversion (port of ``jaxlsq/serve/convert.py``).

:func:`convert` walks a QAT variables tree (nested dicts of tensors with the
JAX package's collection and layer names), folds each weight quantizer's
(scale, shift) into (scale, zero_point), quantizes + packs the kernels, and
freezes each activation quantizer's qparams; ``weight_group_size`` packs the
int4 dense kernels group-wise instead.

Tensor-parallel placement: :func:`shard_packed` and :func:`shard_converted`
keep jaxlsq's column-parallel rule over a mesh axis ('model'): a pack's
output-feature axis N (the last: a dense (K, N) or a conv HWIO kernel) is
split, its per-channel scale and zero point ride with it, a group-wise
(G, N) scale is split on N with its (1,) zero point whole; a pack whose
per-channel axis is not the last (an embedding table, per row; an expert
stack) or whose N the axis does not divide stays whole, as does a grouped
convolution's (its input channels would split with it).  Each process
keeps its N-slice; the serve-mode layer runs its kernel on that slice and
all-gathers the output along N, so every process holds whole activations
and decode, the caches and the engines run unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core.golden import clamp_scale
from ..core.spec import QuantSpec
from ..observers.quantizer import convert_shift_to_zp
from .pack import PackedWeight, quantize_weight, quantize_weight_grouped

__all__ = ["convert", "serving_bits", "shard_packed", "shard_converted"]


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


# --------------------------------------------------------------------------
# Tensor-parallel placement
# --------------------------------------------------------------------------

def _axis(mesh, axis_name: str):
    i = mesh.mesh_dim_names.index(axis_name)
    return i, mesh.size(i), mesh.get_local_rank(axis_name)


def _column_parallel(p: PackedWeight, size: int) -> bool:
    n = p.data.shape[-1]
    return p.axis == len(p.orig_shape) - 1 and n % size == 0


def shard_packed(packed: PackedWeight, mesh, axis_name: str = "model") -> PackedWeight:
    """This process's part of ``packed`` under column parallelism over
    ``axis_name`` (its N-slice, with its qparams), or ``packed`` itself where
    the rule replicates it."""
    _, size, rank = _axis(mesh, axis_name)
    if not _column_parallel(packed, size):
        return packed
    n = packed.data.shape[-1]
    w = n // size

    def cols(t):
        return t.narrow(t.dim() - 1, rank * w, w).contiguous()

    scale, zp = packed.scale, packed.zero_point
    if packed.group_size is not None and scale.dim() == 2 and scale.shape[1] == n:
        scale = cols(scale)          # (G, N) group scales; the (1,) zp stays
    elif scale.shape[0] == n:
        scale, zp = cols(scale), cols(zp)
    return PackedWeight(cols(packed.data), scale, zp, bits=packed.bits, axis=packed.axis,
                        k_axis=packed.k_axis,
                        orig_shape=tuple(packed.orig_shape[:-1]) + (w,),
                        group_size=packed.group_size)


@torch.no_grad()
def shard_converted(model, mesh, axis_name: str = "model"):
    """Column-parallel placement of a loaded serve-mode model over
    ``axis_name``: every packed layer the rule splits keeps its slice in
    place and all-gathers its output.  Every process of the axis calls it;
    returns ``model``."""
    from .. import _dist
    from ..models.layers import QuantConv, _PackedBuffers

    i, size, rank = _axis(mesh, axis_name)
    part = _dist.Part(mesh.get_group(i), size, rank, -1)
    for owner in model.modules():
        kernel = getattr(owner, "kernel", None)
        if not isinstance(kernel, _PackedBuffers) or kernel.tp is not None:
            continue
        if isinstance(owner, QuantConv) and owner.groups != 1:
            continue
        p = kernel.packed()
        if not _column_parallel(p, size):
            continue
        local = shard_packed(p, mesh, axis_name)
        kernel.data, kernel.scale, kernel.zero_point = local.data, local.scale, local.zero_point
        kernel.orig_shape = local.orig_shape
        kernel.tp = part
    return model
