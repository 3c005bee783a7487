"""``quantize_model``: LSQ quantization of a stock PyTorch model by a module
swap (port of ``jaxlsq/models/quantize.py``).

The JAX package reroutes every stock flax ``nn.Dense``/``nn.Conv``/``nn.Embed``
call through its quantized layers' bodies; the PyTorch idiom for the same
drop-in is ``torch.ao``'s ``prepare_qat``, a swap of modules::

    qmodel = quantize_model(model, default_qconfig(8, 8))   # model is untouched
    step = make_train_step(qmodel, optimizer)               # QAT as usual
    served = quantize_model(model, qc.for_serving("static"))
    interop.load_variables(served, convert(interop.qat_variables(qmodel), qc))

``quantize_model`` returns a deep copy of the model on the card (or on the
device asked for) in which every ``nn.Linear``, ``nn.Conv2d`` and
``nn.Embedding`` of exactly that type is replaced:

* QAT mode: :class:`QuantLinear`, :class:`QuantConv2d`,
  :class:`QuantEmbedding`.  Each keeps the stock module's parameters under
  their stock names and layouts (``weight`` (N, K) and ``bias``; an OIHW
  ``weight`` and ``bias``; a ``weight`` table), so a float state dict loads
  with ``strict=False`` and only the quantizers' keys missing, and adds the
  quantizers as the submodules ``act_fq`` and ``weight_fq``, where the JAX
  package keeps them.  The weight quantizer is per channel over axis 0 (out
  features, out channels, rows), its static scale drawn from the weight the
  model holds at the swap; the activation quantizer covers a Linear's last
  input axis and a convolution's channel axis 1 (NCHW).
* Serve mode (``qconfig.mode == 'serve'``): the packed layers
  ``QuantDense`` (a (K, N) pack through ``wo_matmul``), ``QuantConv`` (the
  HWIO pack) and ``QuantEmbed`` (int8 rows), filled by
  ``interop.load_variables``.

A layer's path is its dotted module name joined with '/' (``layer1.0.conv1``
is ``layer1/0/conv1``), so ``skip`` patterns and ``QConfig`` overrides, both
matched as substrings, pick the layers they pick in the JAX package.  A
layer type the quantized layers do not implement raises ``ValueError``
naming its path unless the path is skipped: ``nn.Conv1d``, ``nn.Conv3d``,
the transposed convolutions, ``nn.Bilinear``, ``nn.MultiheadAttention`` (its
packed ``in_proj_weight`` is no ``nn.Linear``), ``nn.EmbeddingBag`` and the
recurrent layers, a dilated ``nn.Conv2d`` or one with ``padding_mode`` other
than 'zeros', and an ``nn.Embedding`` with ``max_norm``, ``sparse`` or
``scale_grad_by_freq``.  Subclasses of the three stock types, normalization,
activation and pooling layers are left as they are.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from .layers import (QuantConv, QuantDense, QuantEmbed, _fake_quantizer, qat_conv2d,
                     qat_embed)
from .qconfig import QConfig

__all__ = ["quantize_model", "QuantLinear", "QuantConv2d", "QuantEmbedding"]

# parametric stock layers with no quantized counterpart: refused, not left float
_UNSUPPORTED = (nn.Conv1d, nn.Conv3d, nn.ConvTranspose1d, nn.ConvTranspose2d,
                nn.ConvTranspose3d, nn.Bilinear, nn.MultiheadAttention, nn.EmbeddingBag,
                nn.RNNBase, nn.RNNCellBase)
_SWAPPED = (nn.Linear, nn.Conv2d, nn.Embedding)


def _init_weight_quantizer(fq, weight: torch.Tensor) -> None:
    """The weight quantizer's static mean ± 3σ scale from ``weight``."""
    if fq is not None:
        fq.load_quant_state(fq.cfg.init(weight))


class QuantLinear(nn.Module):
    """A stock ``nn.Linear`` with LSQ quantizers: ``weight`` (N, K) and
    ``bias`` as the stock layer's, the weight quantizer per channel over axis
    0, the activation quantizer over the input's last axis;
    ``F.linear(fq_a(x), fq_w(weight), bias)``."""

    def __init__(self, linear: nn.Linear, qconfig: QConfig, device):
        super().__init__()
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.act_fq = _fake_quantizer(qconfig.activation_for_axis(-1),
                                      self.in_features, device)
        self.weight = linear.weight
        self.bias = linear.bias
        self.weight_fq = _fake_quantizer(qconfig.weight_for_axis(0),
                                         self.out_features, device)
        _init_weight_quantizer(self.weight_fq, self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act_fq is not None:
            x = self.act_fq(x)
        w = self.weight if self.weight_fq is None else self.weight_fq(self.weight)
        return F.linear(x, w, self.bias)


def _conv_padding(conv: nn.Conv2d, path: str):
    """A stock ``nn.Conv2d``'s padding as ``conv2d_padded`` takes it, after
    refusing what the quantized convolution does not implement."""
    if tuple(conv.dilation) != (1, 1):
        raise ValueError(f"quantize_model: dilated convolutions are not supported "
                         f"(layer '{path}'); add its path to skip=() to keep it float")
    if conv.padding_mode != "zeros":
        raise ValueError(f"quantize_model: padding_mode={conv.padding_mode!r} is not "
                         f"supported (layer '{path}'); add its path to skip=() to keep "
                         "it float")
    if isinstance(conv.padding, str):  # torch's 'same' is XLA's rule at stride 1
        return conv.padding.upper()
    ph, pw = conv.padding
    return ((ph, ph), (pw, pw))


class QuantConv2d(nn.Module):
    """A stock ``nn.Conv2d`` with LSQ quantizers: the OIHW ``weight`` and
    ``bias`` as the stock layer's, the weight quantizer per channel over axis
    0, the activation quantizer over NCHW's channel axis 1; the convolution
    as ``QuantConv``'s (``qat_conv2d``), with the stock layer's stride and
    groups and ``padding`` as ``conv2d_padded`` takes it."""

    def __init__(self, conv: nn.Conv2d, qconfig: QConfig, device, padding):
        super().__init__()
        self.padding = padding
        self.in_channels, self.out_channels = conv.in_channels, conv.out_channels
        self.kernel_size, self.stride = tuple(conv.kernel_size), tuple(conv.stride)
        self.groups = conv.groups
        self.act_fq = _fake_quantizer(qconfig.activation_for_axis(1),
                                      self.in_channels, device)
        self.weight = conv.weight
        self.bias = conv.bias
        self.weight_fq = _fake_quantizer(qconfig.weight_for_axis(0),
                                         self.out_channels, device)
        _init_weight_quantizer(self.weight_fq, self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qat_conv2d(self, x, self.weight, self.stride, self.padding, self.groups)


class QuantEmbedding(nn.Module):
    """A stock ``nn.Embedding`` with its ``weight`` table fake-quantized
    whole, per row (axis 0), then gathered (``padding_idx`` kept)."""

    def __init__(self, emb: nn.Embedding, qconfig: QConfig, device):
        super().__init__()
        self.num_embeddings, self.embedding_dim = emb.num_embeddings, emb.embedding_dim
        self.padding_idx = emb.padding_idx
        self.weight = emb.weight
        self.weight_fq = _fake_quantizer(qconfig.weight_for_axis(0),
                                         self.num_embeddings, device)
        _init_weight_quantizer(self.weight_fq, self.weight)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return qat_embed(self, tokens, self.weight, self.padding_idx)


def _swap(mod: nn.Module, path: str, qconfig: QConfig, device) -> nn.Module:
    """The quantized module that takes ``mod``'s place (``mod`` is of one of
    the three stock types exactly)."""
    where = tuple(path.split("/")) if path else ()
    serve = qconfig.mode == "serve"
    if isinstance(mod, nn.Embedding):
        bad = [k for k, off in (("max_norm", mod.max_norm is None), ("sparse", not mod.sparse),
                                ("scale_grad_by_freq", not mod.scale_grad_by_freq)) if not off]
        if bad:
            raise ValueError(f"quantize_model: nn.Embedding with {', '.join(bad)} is not "
                             f"supported (layer '{path}'); add its path to skip=() to keep "
                             "it float")
        if serve:
            return QuantEmbed(mod.num_embeddings, mod.embedding_dim, qconfig, path=where,
                              device=device)
        return QuantEmbedding(mod, qconfig.resolve(where), device)
    if isinstance(mod, nn.Conv2d):
        padding = _conv_padding(mod, path)
        if serve:
            return QuantConv(mod.in_channels, mod.out_channels, tuple(mod.kernel_size),
                             qconfig, strides=tuple(mod.stride), padding=padding,
                             use_bias=mod.bias is not None, feature_group_count=mod.groups,
                             path=where, device=device)
        return QuantConv2d(mod, qconfig.resolve(where), device, padding)
    if serve:
        return QuantDense(mod.in_features, mod.out_features, qconfig,
                          use_bias=mod.bias is not None, path=where, device=device)
    return QuantLinear(mod, qconfig.resolve(where), device)


def quantize_model(model: nn.Module, qconfig: QConfig, *, skip: Sequence[str] = (),
                   device=None) -> nn.Module:
    """A copy of ``model`` on ``device`` (the card unless the caller names
    another; with no card and no device it raises) with every ``nn.Linear``,
    ``nn.Conv2d`` and ``nn.Embedding`` of exact type swapped for its quantized
    twin under ``qconfig`` (QAT or serve mode, overrides by path), except the
    layers whose '/'-joined path contains a ``skip`` pattern, which stay
    float.  A serve-mode copy takes no gradient.  ``model`` itself is not
    changed."""
    dev = resolve_device(device)
    skip = tuple(skip)
    qmodel = copy.deepcopy(model).to(dev)
    swapped = {}  # id(stock module) -> its twin, so a shared layer stays shared
    for name, mod in list(qmodel.named_modules()):
        path = name.replace(".", "/")
        if any(pat in path for pat in skip):
            continue
        if type(mod) in _SWAPPED:
            swapped[id(mod)] = _swap(mod, path, qconfig, dev)
        elif isinstance(mod, _UNSUPPORTED):
            raise ValueError(
                f"quantize_model: layer '{path}' ({type(mod).__name__}) has parameters "
                "but no quantized counterpart; add a skip=() pattern to keep it float")
    if id(qmodel) in swapped:
        qmodel = swapped[id(qmodel)]
    for parent in list(qmodel.modules()):
        for child_name, child in list(parent.named_children()):
            if id(child) in swapped:
                setattr(parent, child_name, swapped[id(child)])
    if qconfig.mode == "serve":  # as the port's serve-mode nets: no gradient
        qmodel.requires_grad_(False)
    return qmodel
