"""Carry a JAX package variables tree into the port's model.

:func:`load_variables` takes the tree ``QuantTransformerLM.init`` (or
training, or ``jaxlsq.serve.convert``) produced in the JAX package, as nested
dicts of numpy arrays (or tensors), and fills a serve-mode
:class:`jaxlsq_torch.models.QuantTransformerLM`:

* a QAT-mode tree (``params``/``qparams``[/``quant_state``]) is first passed
  through the port's own :func:`jaxlsq_torch.serve.convert` (``quant_state``
  is not read);
* a converted tree (``params``/``quantized``) is loaded as it is; each packed
  weight is a ``PackedWeight`` or a dict of its fields (``data``, ``scale``,
  ``zero_point``, ``bits``, ``axis``, ``k_axis``, ``orig_shape``).

Layouts are the JAX package's: dense kernels (K, N); the ``qkv`` columns are
``[q | k | v]``; flax LayerNorm ``scale``/``bias`` are the LayerNorm weight
and bias; ``lm_head`` has no bias.  Every buffer of the model must be given,
and nothing else.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .serve.convert import convert
from .serve.pack import PackedWeight

__all__ = ["load_variables"]

_PACKED_FIELDS = ("data", "scale", "zero_point")


def _to_torch(tree, device):
    if isinstance(tree, PackedWeight):
        return tree.to(device)
    if isinstance(tree, dict):
        if all(k in tree for k in _PACKED_FIELDS) and "bits" in tree:
            return PackedWeight(
                data=_to_torch(tree["data"], device),
                scale=_to_torch(tree["scale"], device),
                zero_point=_to_torch(tree["zero_point"], device),
                bits=int(tree["bits"]), axis=int(tree["axis"]),
                k_axis=int(tree["k_axis"]),
                orig_shape=tuple(int(d) for d in tree["orig_shape"]),
                group_size=tree.get("group_size"))
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.to(device)
    return torch.as_tensor(np.array(tree)).to(device)


def _take(tree: Dict[str, Any], key: str, path: str):
    if not isinstance(tree, dict) or key not in tree:
        raise KeyError(f"variables tree lacks {path}/{key}")
    return tree.pop(key)


def _copy(dst: torch.Tensor, src: torch.Tensor, path: str) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{path}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
    dst.copy_(src.to(dst.dtype))


def _dense(layer, p, q, path):
    layer.kernel.load(_take(q, "kernel", f"quantized/{path}"))
    if layer.aspec is not None:
        _copy(layer.act_scale, _take(q, "act_scale", f"quantized/{path}"),
              f"{path}/act_scale")
        _copy(layer.act_zp, _take(q, "act_zp", f"quantized/{path}"),
              f"{path}/act_zp")
    if layer.bias is not None:
        _copy(layer.bias, _take(p, "bias", f"params/{path}"), f"{path}/bias")


def _layer_norm(ln, p, path):
    _copy(ln.weight, _take(p, "scale", f"params/{path}"), f"{path}/scale")
    _copy(ln.bias, _take(p, "bias", f"params/{path}"), f"{path}/bias")


def _leftover(tree, path=""):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _leftover(v, f"{path}/{k}")
        return out
    return [path]


@torch.no_grad()
def load_variables(model, variables: Dict[str, Any]) -> None:
    """Load a JAX-package variables tree (QAT-mode or converted) into ``model``."""
    # quant_state holds observer counters (training state) and, for
    # DenseGeneral layers, flattening markers; the LM has no DenseGeneral
    tree = _to_torch({k: v for k, v in variables.items() if k != "quant_state"},
                     model.device)
    if "qparams" in tree:
        tree = convert(tree, model.qconfig)
    params = tree.pop("params")
    quant = tree.pop("quantized")
    if tree:
        raise ValueError(f"unexpected collections {sorted(tree)}")

    model.tok_emb.embedding.load(
        _take(_take(quant, "tok_emb", "quantized"), "embedding", "quantized/tok_emb"))
    params.pop("tok_emb", None)  # converted embedding leaves an empty node
    if model.pos_embedding == "learned":
        _copy(model.pos_emb, _take(params, "pos_emb", "params"), "pos_emb")
    for i, blk in enumerate(model.blocks()):
        name = f"block{i}"
        p = _take(params, name, "params")
        q = _take(quant, name, "quantized")
        _layer_norm(blk.ln1, _take(p, "ln1", f"params/{name}"), f"{name}/ln1")
        _layer_norm(blk.ln2, _take(p, "ln2", f"params/{name}"), f"{name}/ln2")
        for sub in ("qkv", "proj", "mlp_up", "mlp_down"):
            _dense(getattr(blk, sub), p.pop(sub, {}),
                   _take(q, sub, f"quantized/{name}"), f"{name}/{sub}")
        left = _leftover(p, f"params/{name}") + _leftover(q, f"quantized/{name}")
        if left:
            raise ValueError(f"unexpected variables {left}")
    _layer_norm(model.ln_f, _take(params, "ln_f", "params"), "ln_f")
    _dense(model.lm_head, params.pop("lm_head", {}),
           _take(quant, "lm_head", "quantized"), "lm_head")
    left = _leftover(params, "params") + _leftover(quant, "quantized")
    if left:
        raise ValueError(f"unexpected variables {left}")
