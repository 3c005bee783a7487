"""Carry JAX package variables trees into the port's models and back.

:func:`load_variables` takes the tree the JAX package's ``model.init`` (or
training, or ``jaxlsq.serve.convert``) produced, as nested dicts of numpy
arrays (or tensors), and fills a serve-mode model of the port: the
:class:`jaxlsq_torch.models.QuantTransformerLM`, or a conv net
(``QuantResNet``, ``QuantMobileNetV2``, ``QuantCNN``, a stock model swapped
by ``models.quantize_model`` in serve mode, or any model of ``QuantConv``,
``QuantDense``, ``QuantDenseGeneral``, ``QuantEmbed`` and BatchNorm modules
named as the flax modules are):

* a QAT-mode tree (``params``/``qparams``[/``quant_state``/``batch_stats``])
  is first passed through the port's own :func:`jaxlsq_torch.serve.convert`
  (``quant_state`` is read only for the ``dg_flat`` markers);
* a converted tree (``params``/``quantized``[/``batch_stats``]) is loaded as
  it is; each packed weight is a ``PackedWeight`` or a dict of its fields
  (``data``, ``scale``, ``zero_point``, ``bits``, ``axis``, ``k_axis``,
  ``orig_shape`` and ``group_size``, whose (G, N) scale a group-wise pack
  brings along).

Layouts are the JAX package's: dense kernels (K, N); conv kernels packed
HWIO, per-channel axis 3, int4 pairs along the in axis (the layer keeps the
pack as it is and permutes the dequantized kernel to OIHW); the ``qkv``
columns are ``[q | k | v]``; flax LayerNorm ``scale``/``bias`` are the
LayerNorm weight and bias; BatchNorm's ``scale``/``bias`` are in ``params``
and its ``mean``/``var`` in ``batch_stats``; ``lm_head`` has no bias.  Every
buffer of the model must be given, and nothing else.

:func:`load_qat_variables` and its inverse :func:`qat_variables` carry a QAT
model's whole state (``params``/``qparams``/``quant_state``/``batch_stats``,
as ``create_train_state`` or ``model.init`` gives it) into a QAT-mode model
of the port (``QuantResNet``, ``QuantMobileNetV2``, ``QuantCNN``,
``QuantMLP``, the QAT-mode ``QuantTransformerLM``, or any model of
``QuantConv``, ``QuantDense``, ``QuantEmbed``, ``BatchNorm``,
``nn.LayerNorm`` and ``FakeQuantize`` modules named as the flax modules are,
plus a learned ``pos_emb`` parameter) and out again.  A ``QuantMoE``'s
router is the JAX package's ``router/kernel`` (the Linear's weight
transposed), its ``experts_up``/``experts_down`` the stacked (E, K, N)
``kernel``, ``bias`` and quantizers (converted: the per-expert packs and
activation qparams in ``quantized``).  Conv kernels are HWIO
there and OIHW here (a depthwise (3, 3, 1, C) there is (C, 1, 3, 3) here);
a per-channel conv weight's qparams are the same (C,) vectors (axis 3
there, 0 here); the quantizers' counters, flags and observer count are
their buffers, of the JAX package's types (int32, bool, int32), and a
histogram observer's ``histogram`` its ``obs_hist`` buffer.

Stock layers (``quantize_model``'s QAT twins and the layers it leaves float)
carry as the JAX package's stock flax layers: a Linear's (N, K) ``weight`` is
the (K, N) ``kernel`` transposed, a Conv2d's OIHW ``weight`` the HWIO
``kernel``, an Embedding's ``weight`` the ``embedding``; a stock
``nn.BatchNorm*d``'s ``weight``/``bias`` are flax's ``scale``/``bias`` and its
``running_mean``/``running_var`` the ``batch_stats`` ``mean``/``var``.  A
``QuantDenseGeneral`` keeps the stock ``(*in_dims, *features)`` kernel, and
its ``dg_flat`` marker is in ``quant_state``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm

from ._device import device_of
from .models.layers import (FakeQuantize, QuantConv, QuantDense, QuantDenseGeneral,
                            QuantEmbed)
from .models.moe import _ExpertDense
from .models.norm import BatchNorm
from .models.quantize import QuantConv2d, QuantEmbedding, QuantLinear
from .models.zoo import QuantTransformerLM
from .observers.quantizer import STATE_DTYPES, STATE_FIELDS, QuantizerState
from .serve.convert import convert
from .serve.pack import PackedWeight

__all__ = ["load_variables", "load_qat_variables", "qat_variables"]

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
                group_size=(None if tree.get("group_size") is None
                            else int(tree["group_size"])))
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


def _packed_layer(layer, p, q, path):
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
    """Load a JAX-package variables tree (QAT-mode or converted) into the
    serve-mode ``model``.  A QAT-mode tree is converted under
    ``model.qconfig`` (its ``quant_state`` read only for the ``dg_flat``
    markers of ``QuantDenseGeneral`` layers); a ``quantize_model`` copy holds
    no qconfig and takes the tree converted: ``convert(tree, qc)``."""
    tree = _to_torch(dict(variables), device_of(model))
    if "qparams" in tree:
        tree = convert(tree, model.qconfig)
    tree.pop("quant_state", None)
    params = tree.pop("params")
    quant = tree.pop("quantized")
    stats = tree.pop("batch_stats", {})
    if tree:
        raise ValueError(f"unexpected collections {sorted(tree)}")
    if isinstance(model, QuantTransformerLM):
        _load_lm(model, params, quant)
    else:
        _load_net(model, params, quant, stats)
    left = (_leftover(params, "params") + _leftover(quant, "quantized")
            + _leftover(stats, "batch_stats"))
    if left:
        raise ValueError(f"unexpected variables {left}")


def _load_lm(model, params, quant) -> None:
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
        subs = [("qkv", blk.qkv), ("proj", blk.proj)]
        if blk.moe is None:
            subs += [("mlp_up", blk.mlp_up), ("mlp_down", blk.mlp_down)]
        else:  # the float router from params, the expert stacks packed
            pm, qm = p.pop("moe", {}), _take(q, "moe", f"quantized/{name}")
            _float_layer(blk.moe.router, _take(pm, "router", f"params/{name}/moe"),
                         f"{name}/moe/router")
            for sub in ("experts_up", "experts_down"):
                _packed_layer(getattr(blk.moe, sub), pm.pop(sub, {}),
                              _take(qm, sub, f"quantized/{name}/moe"), f"{name}/moe/{sub}")
            left = (_leftover(pm, f"params/{name}/moe")
                    + _leftover(qm, f"quantized/{name}/moe"))
            if left:
                raise ValueError(f"unexpected variables {left}")
        for sub, layer in subs:
            _packed_layer(layer, p.pop(sub, {}), _take(q, sub, f"quantized/{name}"),
                          f"{name}/{sub}")
        left = _leftover(p, f"params/{name}") + _leftover(q, f"quantized/{name}")
        if left:
            raise ValueError(f"unexpected variables {left}")
    _layer_norm(model.ln_f, _take(params, "ln_f", "params"), "ln_f")
    _packed_layer(model.lm_head, params.pop("lm_head", {}),
           _take(quant, "lm_head", "quantized"), "lm_head")


def _load_net(model, params, quant, stats) -> None:
    """A serve-mode net (the port's conv nets, or a stock model swapped by
    ``quantize_model``): each packed layer's pack and activation qparams from
    ``quantized``, its bias from ``params``; each BatchNorm's affine from
    ``params`` and its running statistics from ``batch_stats``; a layer left
    float (a ``skip`` of ``quantize_model``) and a LayerNorm from
    ``params``."""
    for name, mod in model.named_modules():
        path = tuple(name.split("."))
        where = "/".join(path)
        if isinstance(mod, (QuantConv, QuantDense, QuantDenseGeneral, QuantEmbed, _ExpertDense)):
            if mod.qat:
                raise ValueError(f"{where} is a QAT-mode layer: load_variables fills "
                                 "a serve-mode model (load_qat_variables a QAT one)")
            q = _pop_node(quant, path, "quantized")
            if isinstance(mod, QuantEmbed):
                mod.embedding.load(_take(q, "embedding", f"quantized/{where}"))
                p = {}
            else:
                p = {} if mod.bias is None else _pop_node(params, path, "params")
                _packed_layer(mod, p, q, where)
            left = _leftover(p, f"params/{where}") + _leftover(q, f"quantized/{where}")
            if left:
                raise ValueError(f"unexpected variables {left}")
        elif isinstance(mod, (BatchNorm, _BatchNorm)):
            _batch_norm(mod, params, stats, path)
        elif isinstance(mod, nn.LayerNorm) or type(mod) in _FLOAT_LAYERS:
            _float_layer(mod, _pop_node(params, path, "params"), where)


# stock layers that carry float parameters as the JAX package's stock ones do
_FLOAT_LAYERS = (nn.Linear, nn.Conv2d, nn.Embedding)


def _bn_tensors(mod):
    """A BatchNorm's tensors by the JAX package's names: the port's flax-rule
    ``BatchNorm``, or a stock ``nn.BatchNorm*d`` (weight/bias are flax's
    scale/bias, running_mean/running_var its batch_stats mean/var; torch's
    ``num_batches_tracked`` has no counterpart and is not carried)."""
    if isinstance(mod, BatchNorm):
        return {"scale": mod.scale, "bias": mod.bias}, {"mean": mod.mean, "var": mod.var}
    p = {"scale": mod.weight, "bias": mod.bias} if mod.affine else {}
    s = ({"mean": mod.running_mean, "var": mod.running_var}
         if mod.track_running_stats else {})
    return p, s


def _batch_norm(mod, params, stats, path) -> None:
    """A BatchNorm's affine from the ``params`` collection and its running
    statistics from ``batch_stats``, each node popped at ``path``."""
    where = "/".join(path)
    for tensors, col, name in zip(_bn_tensors(mod), (params, stats),
                                  ("params", "batch_stats")):
        if not tensors:
            continue
        node = _pop_node(col, path, name)
        for key, dst in tensors.items():
            _copy(dst, _to_torch(_take(node, key, where), dst.device), f"{where}/{key}")
        if node:
            raise ValueError(f"unexpected variables {sorted(node)} at {name}/{where}")


def _weight_views(mod):
    """A layer's weight tensor, its params key in the JAX package and the
    maps from the JAX package's layout to the port's and back: a Linear's
    (N, K) weight is the (K, N) kernel transposed, a Conv2d's OIHW weight the
    HWIO kernel, an embedding table the same array."""
    ident = (lambda a: a, lambda a: a)
    if isinstance(mod, (QuantEmbed, QuantEmbedding, nn.Embedding)):
        return (mod.embedding if isinstance(mod, QuantEmbed) else mod.weight,
                "embedding", *ident)
    if isinstance(mod, (QuantConv, QuantConv2d, nn.Conv2d)):
        w = mod.kernel if isinstance(mod, QuantConv) else mod.weight
        return (w, "kernel", lambda a: a.permute(3, 2, 0, 1),  # HWIO <-> OIHW
                lambda a: a.transpose(2, 3, 1, 0))
    if isinstance(mod, (QuantLinear, nn.Linear)):
        return mod.weight, "kernel", lambda a: a.T, lambda a: a.T
    return mod.kernel, "kernel", *ident  # QuantDense, QuantDenseGeneral, _ExpertDense


def _float_layer(mod, p, where) -> None:
    """A float layer's weight (and bias), or a LayerNorm's scale and bias."""
    if isinstance(mod, nn.LayerNorm):
        triples = ((mod.weight, "scale", None), (mod.bias, "bias", None))
    else:
        w, key, from_jax, _ = _weight_views(mod)
        triples = ((w, key, from_jax), (getattr(mod, "bias", None), "bias", None))
    for dst, key, fn in triples:
        if dst is not None:
            src = _to_torch(_take(p, key, f"params/{where}"), dst.device)
            _copy(dst, src if fn is None else fn(src), f"{where}/{key}")
    if p:
        raise ValueError(f"unexpected variables {sorted(p)} at params/{where}")


def _pop_node(tree: Dict[str, Any], path, collection: str):
    node = tree
    for key in path[:-1]:
        node = _take_node(node, key, collection, path)
    return _take_node(node, path[-1], collection, path, pop=True)


def _take_node(node, key, collection, path, pop=False):
    if not isinstance(node, dict) or key not in node:
        raise KeyError(f"variables tree lacks {collection}/{'/'.join(path)}")
    return node.pop(key) if pop else node[key]


def _copy_dicts(tree):
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def _prune(tree):
    """The tree without its empty dicts (what is left after loading)."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _prune(v) for k, v in tree.items()}
    return {k: v for k, v in out.items() if v != {}}


_KERNEL_LAYERS = (QuantConv, QuantDense, QuantDenseGeneral, QuantEmbed, QuantLinear,
                  QuantConv2d, QuantEmbedding, _ExpertDense)


def _qat_modules(model):
    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(mod, (FakeQuantize, BatchNorm, _BatchNorm, nn.LayerNorm)):
            yield path, mod
        elif isinstance(mod, _KERNEL_LAYERS) and getattr(mod, "qat", True):
            yield path, mod
        elif type(mod) in _FLOAT_LAYERS:
            yield path, mod


def _pos_emb(model):
    """A learned ``pos_emb`` parameter of ``model`` (the LM's), or None."""
    p = getattr(model, "pos_emb", None)
    return p if isinstance(p, nn.Parameter) else None


@torch.no_grad()
def load_qat_variables(model, tree: Dict[str, Any]) -> None:
    """Load a JAX-package QAT variables tree into the QAT-mode ``model``.
    Every variable of the model must be given, and nothing else."""
    dev = device_of(model)
    tree = _copy_dicts(tree)  # nodes are popped as they are loaded
    cols = {c: tree.pop(c, {}) for c in ("params", "qparams", "quant_state",
                                         "batch_stats")}
    if tree:
        raise ValueError(f"unexpected collections {sorted(tree)}")

    def get(node, key, path):
        return _to_torch(_take_node(node, key, "", path), dev)

    def node_at(col, path):
        node = cols[col]
        for key in path:
            node = _take_node(node, key, col, path)
        return node

    for path, mod in _qat_modules(model):
        where = "/".join(path)
        if isinstance(mod, FakeQuantize):
            qp = _pop_node(cols["qparams"], path, "qparams")["qp"]
            qs = _pop_node(cols["quant_state"], path, "quant_state")["qs"]
            bufs = mod.obs_buffers()
            obs = {f: get(qs["obs"], f, path) for f in bufs}
            obs["seen"] = obs["seen"].to(torch.int32).reshape(())
            st = QuantizerState(
                scale=get(qp, "scale", path), shift=get(qp, "shift", path),
                obs=mod.obs_type(**obs),
                **{f: get(qs, f, path).to(STATE_DTYPES[f]).reshape(())
                   for f in STATE_FIELDS})
            shapes = [(st.scale, mod.scale)] + [(obs[f], b) for f, b in bufs.items()]
            for a, b in shapes:
                if a.shape != b.shape:
                    raise ValueError(f"{where}: shape {tuple(a.shape)} != {tuple(b.shape)}")
            mod.load_quant_state(st)
        elif isinstance(mod, (BatchNorm, _BatchNorm)):
            _batch_norm(mod, cols["params"], cols["batch_stats"], path)
        elif isinstance(mod, nn.LayerNorm):
            _float_layer(mod, _pop_node(cols["params"], path, "params"), where)
        else:
            p = node_at("params", path)
            w, key, from_jax, _ = _weight_views(mod)
            _copy(w, from_jax(_to_torch(_take(p, key, f"params/{where}"), dev)),
                  f"{where}/{key}")
            if getattr(mod, "bias", None) is not None:
                _copy(mod.bias, _to_torch(_take(p, "bias", f"params/{where}"), dev),
                      f"{where}/bias")
            if isinstance(mod, QuantDenseGeneral):
                flat = _to_torch(_take(node_at("quant_state", path), "dg_flat",
                                       f"quant_state/{where}"), dev)
                if flat.tolist() != mod.dg_flat.tolist():
                    raise ValueError(f"{where}/dg_flat: {flat.tolist()} != "
                                     f"{mod.dg_flat.tolist()}")
    if _pos_emb(model) is not None:
        _copy(model.pos_emb, _to_torch(_take(cols["params"], "pos_emb", "params"), dev),
              "pos_emb")
    left = _prune(cols)
    if left:
        raise ValueError(f"unexpected variables {_leftover(left)}")


def qat_variables(model) -> Dict[str, Any]:
    """The QAT-mode ``model``'s variables as a JAX-package tree of numpy
    arrays (the inverse of :func:`load_qat_variables`)."""
    cols = {c: {} for c in ("params", "qparams", "quant_state", "batch_stats")}

    def put(col, path, value):
        node = cols[col]
        for key in path:
            node = node.setdefault(key, {})
        node.update(value)

    def np_(t):
        return t.detach().cpu().numpy().copy()

    for path, mod in _qat_modules(model):
        if isinstance(mod, FakeQuantize):
            put("qparams", path, {"qp": {"scale": np_(mod.scale), "shift": np_(mod.shift)}})
            qs = {f: np_(getattr(mod, f)) for f in STATE_FIELDS}
            qs["obs"] = {f: np_(b) for f, b in mod.obs_buffers().items()}
            put("quant_state", path, {"qs": qs})
        elif isinstance(mod, (BatchNorm, _BatchNorm)):
            tp, ts = _bn_tensors(mod)
            if tp:
                put("params", path, {k: np_(v) for k, v in tp.items()})
            if ts:
                put("batch_stats", path, {k: np_(v) for k, v in ts.items()})
        elif isinstance(mod, nn.LayerNorm):
            put("params", path, {"scale": np_(mod.weight), "bias": np_(mod.bias)})
        else:
            w, key, _, to_jax = _weight_views(mod)
            put("params", path, {key: to_jax(np_(w))})
            if getattr(mod, "bias", None) is not None:
                put("params", path, {"bias": np_(mod.bias)})
            if isinstance(mod, QuantDenseGeneral):
                put("quant_state", path, {"dg_flat": np_(mod.dg_flat)})
    if _pos_emb(model) is not None:
        cols["params"]["pos_emb"] = np_(model.pos_emb)
    return {c: v for c, v in cols.items() if v}
