"""Quantized layers (port of ``jaxlsq/models/layers.py``).

QAT mode (fake-quant training):

* :class:`FakeQuantize` is one LSQ quantizer as a module: ``scale``/``shift``
  are ``nn.Parameter``s; the observer state (``obs_min``, ``obs_max``,
  ``obs_seen``, and ``obs_hist`` for a histogram observer only) and the
  phase counters and flags (``current_batch``,
  ``n_batches`` int32; ``fake_quant_enabled``, ``observer_enabled``,
  ``learning_enabled`` bool) are buffers, the JAX package's quant_state, so
  ``state_dict`` carries them.  The buffers are the one source of truth and
  every write to them is in place, so a captured CUDA graph keeps reading
  the model's own state.  An observer writes the parameters in place, under
  ``no_grad``, in the forward, so the optimizer's update lands on top of the
  observer's values (the JAX package's train-step contract).
* It runs one of two regimes: the eager one (``traced`` False) decides the
  phase on the host from a mirror of the counters and flags, which is
  refilled from the buffers by one read whenever something other than the
  eager forward wrote them (a toggle, ``load_state_dict``, the traced
  regime, a graph replay), and writes back only what changed; the traced one
  (``traced`` True, set by ``make_train_step(jit=True)``) runs
  ``LSQQuantizer.forward_traced`` on the buffers themselves.
* :class:`QuantDense` keeps the JAX package's (K, N) kernel, per-channel
  axis 1; :class:`QuantConv` takes NCHW activations and an OIHW kernel, so
  its weight's per-channel axis is 0 (the JAX package: NHWC, HWIO, axis 3).
  The matmul and the convolution are plain PyTorch, as the JAX package
  leaves them to XLA.  :class:`QuantEmbed` fake-quantizes its whole table
  per row, then gathers.  :class:`QuantDenseGeneral` contracts several axes
  on a flattened (K, N) view of its stock-layout kernel.
* :func:`sow_loss` records an extra term of the training objective (the JAX
  package's ``losses`` collection); ``make_train_step`` adds the terms of
  its forward (:func:`collect_losses`).

Serve mode: :class:`QuantDense` holds a packed (K, N) kernel as buffers and
runs the fused weight-only matmul (``serve.matmul.wo_matmul``), or under
``act_mode='static_int8'`` (an activation quantizer, per tensor) the int8 x
int8 ``static_int8_matmul`` and under ``'dynamic'`` ``dynamic_int8_matmul``;
:class:`QuantConv` holds its kernel packed in the JAX package's HWIO layout
(per-channel axis 3, int4 along the in axis 2), dequantizes it at each
forward and runs the convolution (plain PyTorch, as the JAX package's
``conv_general_dilated``), or under ``'static_int8'`` the integer
``static_int8_conv`` where the JAX package takes it (an int8 pack, symmetric
weights, a per-tensor activation); :class:`QuantEmbed` holds an int8 table
and dequantizes only the gathered rows; :class:`QuantDenseGeneral` runs its
packed (K, N) view as :class:`QuantDense`.  All four are filled by
:func:`jaxlsq_torch.interop.load_variables`.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import _dist
from .._device import resolve_device
from ..observers.quantizer import (STATE_DTYPES, STATE_FIELDS, LSQQuantizer,
                                   QuantizerState)
from ..serve.convert import serving_bits
from ..serve.matmul import (conv_pads, dynamic_int8_matmul, same_padding,  # noqa: F401
                             static_int8_conv, static_int8_matmul, wo_matmul)
from ..serve.pack import PackedWeight, dequantize_weight
from .qconfig import QConfig

__all__ = ["FakeQuantize", "QuantDense", "QuantDenseGeneral", "QuantConv", "QuantEmbed",
           "conv2d_padded", "qat_conv2d", "qat_embed", "static_act_quant", "refresh_host_state",
           "quant_state_frozen", "collect_losses", "sow_loss", "fake_quant_hook"]


def static_act_quant(x: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
                     aspec, axis: int = -1) -> torch.Tensor:
    """Frozen fake-quant of an activation with converted qparams; per-channel
    qparams lie along ``axis`` (the last for a dense input, 1 for NCHW)."""
    if scale.shape[0] > 1:
        shape = [1] * x.dim()
        shape[axis] = -1
        s = scale.reshape(shape)
    else:
        s = scale.reshape(())
    z = zp.to(x.dtype).reshape(s.shape)
    xq = torch.round(torch.clamp(x / s + z, aspec.quant_min, aspec.quant_max))
    return ((xq - z) * s).to(x.dtype)


class FakeQuantize(nn.Module):
    """One LSQ/LSQ+ fake-quantizer (``cfg``) over ``num_channels`` channels.

    ``forward(x)`` runs ``cfg``'s phase machine with ``self.training`` as the
    training flag, in the traced regime when ``traced`` is set.  With
    ``persist_state`` False (``make_eval_step`` sets it) the forward uses
    what the observer would write but keeps nothing, as the JAX package's
    eval step discards its mutated collections.
    """

    # the observer state's fields and the buffers that hold them (a
    # histogram observer's ``histogram`` only where it has one)
    OBS_BUFFERS = {"min_val": "obs_min", "max_val": "obs_max", "seen": "obs_seen",
                   "histogram": "obs_hist"}

    def __init__(self, cfg: LSQQuantizer, num_channels: int = 1, device=None):
        super().__init__()
        self.cfg = cfg
        st = cfg.init(num_channels=num_channels,
                      device=resolve_device(device)).on_device()
        self.scale = nn.Parameter(st.scale)
        self.shift = nn.Parameter(st.shift)
        self.obs_type = type(st.obs)
        fields = {f.name for f in dataclasses.fields(st.obs)}
        for f, buf in self.OBS_BUFFERS.items():
            if f in fields:
                self.register_buffer(buf, getattr(st.obs, f))
        for f in STATE_FIELDS:
            self.register_buffer(f, getattr(st, f))
        self._host = None           # host mirror of the STATE_FIELDS buffers
        self._host_versions = None  # their version counters when it was filled
        self.persist_state = True
        self.traced = False

    # ----------------------------------------------------- the host mirror

    def _versions(self):
        return tuple(getattr(self, f)._version for f in STATE_FIELDS)

    def host_fresh(self) -> bool:
        """Whether the mirror holds the buffers' values: nothing has written
        them in place since it was filled (a graph replay bumps no version
        counter; ``invalidate_host_state`` covers it)."""
        return self._host is not None and self._host_versions == self._versions()

    def invalidate_host_state(self) -> None:
        self._host = None

    def _set_host(self, values) -> None:
        self._host = dict(values)
        self._host_versions = self._versions()

    def host_state(self) -> dict:
        """The counters and flags as host values (one read if stale)."""
        if not self.host_fresh():
            refresh_host_state([self])
        return self._host

    # ------------------------------------------------------------- state

    def obs_buffers(self) -> Dict[str, torch.Tensor]:
        """The observer state's buffers, keyed by its fields."""
        fields = {f.name for f in dataclasses.fields(self.obs_type)}
        return {f: getattr(self, buf) for f, buf in self.OBS_BUFFERS.items()
                if f in fields}

    def quant_state(self, traced: bool = False) -> QuantizerState:
        """The current state: scale/shift are the parameters themselves, the
        observer state the buffers; the counters and flags are the buffers
        (``traced``) or the host mirror."""
        flags = ({f: getattr(self, f) for f in STATE_FIELDS} if traced
                 else self.host_state())
        obs = self.obs_type(**self.obs_buffers())
        return QuantizerState(scale=self.scale, shift=self.shift, obs=obs, **flags)

    @torch.no_grad()
    def load_quant_state(self, st: QuantizerState) -> None:
        """Write ``st`` into the module in place.  Host counters and flags
        are written where they differ from the mirror, which then holds
        them; device ones are copied, and the mirror goes stale."""
        pairs = [(self.scale, st.scale), (self.shift, st.shift)]
        pairs += [(buf, getattr(st.obs, f)) for f, buf in self.obs_buffers().items()]
        for dst, src in pairs:
            if src is not dst:
                dst.copy_(src)
        if st.traced:
            for f in STATE_FIELDS:
                src, dst = getattr(st, f), getattr(self, f)
                if src is not dst:
                    dst.copy_(src)
            self._host = None
            return
        host = self._host if self.host_fresh() else None
        for f in STATE_FIELDS:
            if host is None or host[f] != getattr(st, f):
                getattr(self, f).fill_(getattr(st, f))
        self._set_host({f: getattr(st, f) for f in STATE_FIELDS})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.debug_mode:
            return x
        hook = _HOOK.get()
        if hook is not None:
            return hook(self, x)
        if self.traced:
            out, st = self.cfg.forward_traced(self.quant_state(traced=True), x,
                                              self.training)
            if self.persist_state:
                self.load_quant_state(st)
            return out
        st, modes = self.cfg.advance(self.quant_state(), x, self.training)
        if self.persist_state:
            self.load_quant_state(st)
            scale, shift = self.scale, self.shift
            if st.observer_enabled and self.cfg.observer is not None:
                # the observer's qparams replace the parameters' values: no
                # gradient reaches the parameters, as in the JAX package
                scale, shift = scale.detach(), shift.detach()
        else:
            scale, shift = st.scale, st.shift
        return self.cfg.quantize(x, scale, shift, modes)

    def extra_repr(self) -> str:
        h = self.host_state()
        return (f"{self.cfg.otype}, channels={self.scale.shape[0]}, "
                f"batch {h['current_batch']}/{h['n_batches']}, "
                f"learning={h['learning_enabled']}, observer={h['observer_enabled']}, "
                f"fake_quant={h['fake_quant_enabled']}")


def refresh_host_state(modules) -> None:
    """Refill the host mirror of every stale :class:`FakeQuantize` among
    ``modules`` with one read from each device."""
    by_device = {}
    for m in modules:
        if isinstance(m, FakeQuantize) and not m.host_fresh():
            by_device.setdefault(m.current_batch.device, []).append(m)
    for group in by_device.values():
        vals = torch.stack([getattr(m, f).to(torch.int32) for m in group
                            for f in STATE_FIELDS]).tolist()
        for k, m in enumerate(group):
            row = vals[k * len(STATE_FIELDS):(k + 1) * len(STATE_FIELDS)]
            m._set_host({f: (bool(v) if STATE_DTYPES[f] == torch.bool else int(v))
                         for f, v in zip(STATE_FIELDS, row)})


@contextlib.contextmanager
def quant_state_frozen(modules):
    """While open, every :class:`FakeQuantize` among ``modules`` runs its
    forward as it would but keeps no state (``persist_state`` off): the JAX
    package's apply with the quantizers' collections not mutable."""
    fqs = [m for m in modules if isinstance(m, FakeQuantize)]
    for m in fqs:
        m.persist_state = False
    try:
        yield
    finally:
        for m in fqs:
            m.persist_state = True


# the function that takes every FakeQuantize forward now (a pipeline step's
# microbatch bookkeeping, ``parallel.pipeline``), or None
_HOOK: contextvars.ContextVar = contextvars.ContextVar("fake_quant_hook", default=None)


@contextlib.contextmanager
def fake_quant_hook(hook):
    """While open, every :class:`FakeQuantize` forward is ``hook(fq, x)``."""
    token = _HOOK.set(hook)
    try:
        yield hook
    finally:
        _HOOK.reset(token)


# the list of the innermost open collect_losses, or None
_LOSS_TERMS: contextvars.ContextVar = contextvars.ContextVar("loss_terms", default=None)


@contextlib.contextmanager
def collect_losses():
    """While open, each term a module records with :func:`sow_loss` is
    appended to the yielded list: the JAX package's ``losses`` collection,
    mutable in a training apply.  Outside it a recorded term is dropped, as
    flax drops a write to a collection that is not mutable."""
    terms: list = []
    token = _LOSS_TERMS.set(terms)
    try:
        yield terms
    finally:
        _LOSS_TERMS.reset(token)


def sow_loss(value: torch.Tensor) -> None:
    """Record ``value`` (a weighted term, its sum counts) as a part of the
    training objective: ``make_train_step`` adds the terms recorded in the
    current forward to the loss.  Any other forward drops it."""
    terms = _LOSS_TERMS.get()
    if terms is not None:
        terms.append(value)


def _fake_quantizer(cfg: Optional[LSQQuantizer], channels: int,
                    device) -> Optional[FakeQuantize]:
    return None if cfg is None else FakeQuantize(cfg, channels, device)


class _PackedBuffers(nn.Module):
    """A PackedWeight held as buffers (data, scale, zero_point) plus its
    static layout fields.  A group-wise pack (``group_size`` set) brings its
    own (G, N) scale and (1,) zero point: :meth:`load` re-shapes those two
    buffers to the pack's, whatever qparams the layer was built for."""

    def __init__(self, shape: Sequence[int], bits: int, axis: int, k_axis: int,
                 channels: int, device):
        super().__init__()
        dshape = list(shape)
        if bits == 4:
            dshape[k_axis] = (dshape[k_axis] + 1) // 2  # odd K pads one row
        self.register_buffer("data", torch.zeros(dshape, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(channels, dtype=torch.float32, device=device))
        self.register_buffer("zero_point", torch.zeros(channels, dtype=torch.int32,
                                                       device=device))
        self.bits, self.axis, self.k_axis = bits, axis, k_axis
        self.orig_shape = tuple(shape)
        self.channels = channels
        self.group_size: Optional[int] = None
        # tensor parallelism (serve.convert.shard_converted): the _dist.Part
        # of the axis whose rank-th N / size columns this pack holds
        self.tp = None

    def packed(self) -> PackedWeight:
        return PackedWeight(self.data, self.scale, self.zero_point, bits=self.bits,
                            axis=self.axis, k_axis=self.k_axis,
                            orig_shape=self.orig_shape, group_size=self.group_size)

    @torch.no_grad()
    def load(self, p: PackedWeight) -> None:
        # a per-tensor pack's axis is meaningless (its spec's placeholder)
        axis = p.axis if (self.scale.numel() > 1 or p.group_size) else self.axis
        if (p.bits, axis, p.k_axis, tuple(p.orig_shape)) != (
                self.bits, self.axis, self.k_axis, self.orig_shape):
            raise ValueError(
                f"packed weight layout (bits={p.bits}, axis={p.axis}, "
                f"k_axis={p.k_axis}, shape={tuple(p.orig_shape)}) does not match "
                f"the layer's (bits={self.bits}, axis={self.axis}, "
                f"k_axis={self.k_axis}, shape={self.orig_shape})")
        gs = None if p.group_size is None else int(p.group_size)
        if gs is not None and (len(self.orig_shape) != 2 or self.k_axis != 0
                               or self.orig_shape[0] % gs):
            raise ValueError(f"group size {gs} does not tile the layer's "
                             f"(K, N) = {self.orig_shape}")
        dev = self.data.device
        if gs is not None:
            qshape = ((self.orig_shape[0] // gs, self.orig_shape[1]), (1,))
        else:
            qshape = ((self.channels,), (self.channels,))
        if gs != self.group_size:
            self.scale = torch.ones(qshape[0], dtype=torch.float32, device=dev)
            self.zero_point = torch.zeros(qshape[1], dtype=torch.int32, device=dev)
            self.group_size = gs
        for name in ("data", "scale", "zero_point"):
            buf = getattr(self, name)
            src = torch.as_tensor(getattr(p, name))
            if tuple(src.shape) != tuple(buf.shape):
                raise ValueError(f"packed {name} shape {tuple(src.shape)} != "
                                 f"{tuple(buf.shape)}")
            buf.copy_(src.to(buf.dtype))


def _serve_act_qparams(mod: nn.Module, qc: QConfig, in_features: int, device) -> None:
    """A serve-mode layer's ``act_mode``, activation spec and converted
    activation qparams (``act_scale``/``act_zp`` buffers, per input channel
    or per tensor), when its config quantizes activations."""
    mod.act_mode = qc.act_mode
    mod.aspec = qc.activation.spec if qc.activation is not None else None
    if mod.aspec is not None:
        ac = in_features if mod.aspec.per_channel else 1
        mod.register_buffer("act_scale", torch.ones(ac, dtype=torch.float32,
                                                    device=device))
        mod.register_buffer("act_zp", torch.zeros(ac, dtype=torch.int32, device=device))


class QuantDense(nn.Module):
    """Dense layer, kernel (K, N) with per-channel axis 1, as the JAX package.

    QAT mode: ``y = fq_w(W) applied to fq_a(x) + b``, with the input's
    quantizer over its last axis.  Serve mode: ``y = wo_matmul(x', W) + b``
    where x' is x (``act_mode='none'``) or its frozen fake-quant
    (``'static'``); ``'static_int8'`` runs ``static_int8_matmul`` with the
    converted activation qparams (``wo_matmul`` when the config quantizes no
    activation), ``'dynamic'`` ``dynamic_int8_matmul``, as the JAX package.
    """

    def __init__(self, in_features: int, features: int, qconfig: QConfig, *,
                 use_bias: bool = True, path: Sequence[str] = (), device=None):
        super().__init__()
        qc = qconfig.resolve(tuple(path))
        self.qat = qc.mode != "serve"
        if self.qat:
            device = resolve_device(device)
            self.act_fq = _fake_quantizer(qc.activation_for_axis(-1), in_features,
                                          device)
            self.kernel = nn.Parameter(torch.zeros(in_features, features,
                                                   device=device))
            self.weight_fq = _fake_quantizer(qc.weight_for_axis(1), features, device)
            self.bias = (nn.Parameter(torch.zeros(features, device=device))
                         if use_bias else None)
            return
        _serve_dense(self, qc, in_features, features, (features,), use_bias,
                     resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.qat:
            if self.act_fq is not None:
                x = self.act_fq(x)
            w = self.kernel if self.weight_fq is None else self.weight_fq(self.kernel)
            y = torch.matmul(x, w)
            return y if self.bias is None else y + self.bias
        return _serve_dense_forward(self, x)


def _serve_dense(mod: nn.Module, qc: QConfig, k: int, n: int, bias_shape, use_bias: bool,
                 device) -> None:
    """A serve-mode dense layer's buffers: the packed (K, N) ``kernel``
    (per-channel axis 1), the activation qparams over K and the bias."""
    wspec = qc.required_weight_for_axis(1).spec
    mod.kernel = _PackedBuffers((k, n), serving_bits(wspec), 1, 0,
                                n if wspec.per_channel else 1, device)
    _serve_act_qparams(mod, qc, k, device)
    mod.bias = (nn.Parameter(torch.zeros(bias_shape, device=device), requires_grad=False)
                if use_bias else None)


def _serve_dense_forward(mod: nn.Module, x: torch.Tensor, shape=None) -> torch.Tensor:
    """The packed kernel's product with x by ``act_mode``: ``wo_matmul`` of x
    or its frozen fake-quant (``'static'``), ``static_int8_matmul``
    (``'static_int8'``) or ``dynamic_int8_matmul`` (``'dynamic'``, with or
    without an activation quantizer); reshaped to ``shape`` when given, plus
    the bias, in x's dtype."""
    packed = mod.kernel.packed()
    aspec = mod.aspec
    if mod.act_mode == "dynamic":
        y = dynamic_int8_matmul(x, packed)
    elif aspec is not None and mod.act_mode == "static_int8":
        y = static_int8_matmul(x, packed, mod.act_scale, mod.act_zp, aspec.quant_min,
                               aspec.quant_max)
    else:
        if aspec is not None and mod.act_mode == "static":
            x = static_act_quant(x, mod.act_scale, mod.act_zp, aspec)
        y = wo_matmul(x, packed)
    y = _tp_gather(mod.kernel, y, -1)
    if shape is not None:
        y = y.reshape(shape)
    if mod.bias is not None:
        y = y + mod.bias
    return y.to(x.dtype)


def _tp_gather(kernel: "_PackedBuffers", y: torch.Tensor, dim: int) -> torch.Tensor:
    """A column-parallel pack's output slices all-gathered along ``dim``
    (every process then holds the whole activation); else ``y``."""
    if kernel.tp is None:
        return y
    return _dist.all_gather(y, kernel.tp.group, kernel.tp.size, dim)


class QuantDenseGeneral(nn.Module):
    """The JAX package's ``QuantDenseGeneral``: contracts the input's
    ``axis`` (an int or a tuple, of sizes ``in_dims``; torch infers no
    shapes) against a kernel of the stock layout ``(*in_dims, *features)``,
    bias ``features``.  The contracted axes move to the back in the given
    order and flatten to K, the rest keep their order, so the quantized
    compute runs on the (K, N) view as a :class:`QuantDense`: the activation
    quantizer over the flattened input's last axis, the weight quantizer per
    channel over N (axis 1).  In QAT mode the ``dg_flat`` buffer (int32 (K,
    N)) tells ``serve.convert`` to pack that view; serve mode holds the
    packed (K, N) kernel and runs ``wo_matmul``.  No ``batch_dims``."""

    def __init__(self, in_dims: Union[int, Sequence[int]],
                 features: Union[int, Sequence[int]], qconfig: QConfig, *,
                 axis: Union[int, Sequence[int]] = -1, use_bias: bool = True,
                 path: Sequence[str] = (), device=None):
        super().__init__()
        self.in_dims = (in_dims,) if isinstance(in_dims, int) else tuple(in_dims)
        self.features = (features,) if isinstance(features, int) else tuple(features)
        self.axis = (axis,) if isinstance(axis, int) else tuple(axis)
        if len(self.axis) != len(self.in_dims):
            raise ValueError(f"axis {self.axis} and in_dims {self.in_dims} differ in length")
        k, n = math.prod(self.in_dims), math.prod(self.features)
        qc = qconfig.resolve(tuple(path))
        device = resolve_device(device)
        self.qat = qc.mode != "serve"
        if not self.qat:
            _serve_dense(self, qc, k, n, self.features, use_bias, device)
            return
        self.act_fq = _fake_quantizer(qc.activation_for_axis(-1), k, device)
        self.kernel = nn.Parameter(torch.zeros(self.in_dims + self.features, device=device))
        self.weight_fq = _fake_quantizer(qc.weight_for_axis(1), n, device)
        self.bias = (nn.Parameter(torch.zeros(self.features, device=device))
                     if use_bias else None)
        self.register_buffer("dg_flat", torch.tensor([k, n], dtype=torch.int32,
                                                     device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nd, na = x.dim(), len(self.axis)
        axis = tuple(a % nd for a in self.axis)
        if len(set(axis)) != na:
            raise ValueError(f"QuantDenseGeneral: duplicate axis in {self.axis}")
        if tuple(x.shape[a] for a in axis) != self.in_dims:
            raise ValueError(f"QuantDenseGeneral: input dims {tuple(x.shape)} at axis "
                             f"{self.axis} are not {self.in_dims}")
        x2 = torch.movedim(x, axis, tuple(range(nd - na, nd)))
        lead = tuple(x2.shape[:nd - na])
        x2 = x2.reshape(lead + (-1,))
        shape = lead + self.features
        if not self.qat:
            return _serve_dense_forward(self, x2, shape)
        if self.act_fq is not None:
            x2 = self.act_fq(x2)
        k2 = self.kernel.reshape(x2.shape[-1], -1)
        if self.weight_fq is not None:
            k2 = self.weight_fq(k2)
        y = torch.matmul(x2, k2).reshape(shape)
        return y if self.bias is None else y + self.bias


class QuantConv(nn.Module):
    """2-D convolution with LSQ weight and input-activation quantizers.

    NCHW activations (the activation quantizer's per-channel axis is 1).
    QAT mode: an OIHW ``kernel`` parameter (the weight quantizer's
    per-channel axis is 0).  Serve mode: the kernel packed as the JAX
    package packs it, HWIO with per-channel axis 3 and int4 pairs along the
    in axis 2 (an odd in-axis pads one row), dequantized at each forward and
    permuted to OIHW; ``act_mode='static'`` fake-quantizes the input with the
    converted qparams first, ``'none'`` leaves it; ``'static_int8'`` runs the
    int8 x int8 ``static_int8_conv`` for an int8 pack of symmetric weights
    and a per-tensor activation quantizer, and otherwise falls back to
    ``'static'`` (the JAX package's rule); ``'dynamic'`` raises
    ``ValueError`` as in the JAX package.
    ``padding``: 'SAME' (XLA's rule, see :func:`same_padding`), 'VALID', or
    ``((top, bottom), (left, right))``; it is applied after the activation's
    quantization, as the JAX package pads inside the convolution.
    """

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], qconfig: QConfig, *,
                 strides: Union[int, Sequence[int]] = 1,
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                 use_bias: bool = True, feature_group_count: int = 1,
                 path: Sequence[str] = (), device=None):
        super().__init__()
        qc = qconfig.resolve(tuple(path))
        if in_features % feature_group_count:
            raise ValueError(f"in_features {in_features} is not a multiple of "
                             f"feature_group_count {feature_group_count}")
        device = resolve_device(device)
        self.kh, self.kw = kernel_size
        self.strides = ((strides, strides) if isinstance(strides, int)
                        else tuple(strides))
        if isinstance(padding, str) and padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME', 'VALID' or pairs, got {padding!r}")
        self.padding = padding
        self.groups = feature_group_count
        self.qat = qc.mode != "serve"
        if self.qat:
            self.act_fq = _fake_quantizer(qc.activation_for_axis(1), in_features,
                                          device)
            self.kernel = nn.Parameter(torch.zeros(
                features, in_features // feature_group_count, self.kh, self.kw,
                device=device))
            self.weight_fq = _fake_quantizer(qc.weight_for_axis(0), features, device)
            self.bias = (nn.Parameter(torch.zeros(features, device=device))
                         if use_bias else None)
            return
        if qc.act_mode == "dynamic":
            raise ValueError("act_mode='dynamic' is not supported for conv layers; "
                             "use 'static' or 'none' for models containing QuantConv")
        wspec = qc.required_weight_for_axis(3).spec
        self.weight_symmetric = wspec.symmetric
        c = features if wspec.per_channel else 1
        self.kernel = _PackedBuffers(
            (self.kh, self.kw, in_features // feature_group_count, features),
            serving_bits(wspec), 3, 2, c, device)
        _serve_act_qparams(self, qc, in_features, device)
        self.bias = (nn.Parameter(torch.zeros(features, device=device),
                                  requires_grad=False) if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.qat:
            return qat_conv2d(self, x, self.kernel, self.strides, self.padding, self.groups)
        aspec = self.aspec
        if aspec is not None and self.act_mode == "static_int8" and (
                self.kernel.bits == 8 and self.weight_symmetric and not aspec.per_channel):
            y = static_int8_conv(x, self.kernel.packed(), self.act_scale, self.act_zp,
                                 aspec.quant_min, aspec.quant_max, strides=self.strides,
                                 padding=self.padding, feature_group_count=self.groups)
            y = _tp_gather(self.kernel, y, 1)
            if self.bias is not None:
                y = y + self.bias[:, None, None]
            return y.to(x.dtype)
        if aspec is not None and self.act_mode in ("static", "static_int8"):
            # the float-simulated path (also static_int8's fallback: per-channel
            # activation qparams, affine or int4 weights)
            x = static_act_quant(x, self.act_scale, self.act_zp, aspec, axis=1)
        w = dequantize_weight(self.kernel.packed(), x.dtype).permute(3, 2, 0, 1)
        if self.kernel.tp is None:
            return conv2d_padded(x, w, self.bias, self.strides, self.padding, self.groups)
        y = _tp_gather(self.kernel, conv2d_padded(x, w, None, self.strides, self.padding,
                                                  self.groups), 1)
        return y if self.bias is None else y + self.bias[:, None, None]


def qat_conv2d(mod: nn.Module, x: torch.Tensor, w: torch.Tensor,
               strides: Tuple[int, int], padding, groups: int) -> torch.Tensor:
    """The QAT convolution of ``QuantConv`` and ``quantize_model``'s
    ``QuantConv2d``: ``mod.act_fq`` on NCHW ``x`` (axis 1), ``mod.weight_fq``
    on the OIHW ``w`` (axis 0), then :func:`conv2d_padded` with ``mod.bias``."""
    if mod.act_fq is not None:
        x = mod.act_fq(x)
    if mod.weight_fq is not None:
        w = mod.weight_fq(w)
    return conv2d_padded(x, w, mod.bias, strides, padding, groups)


def conv2d_padded(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                  strides: Tuple[int, int], padding, groups: int) -> torch.Tensor:
    """``F.conv2d`` of NCHW ``x`` and OIHW ``w`` with ``padding`` 'SAME'
    (XLA's rule, :func:`same_padding`), 'VALID' or ``((top, bottom), (left,
    right))``; an uneven pad goes through ``F.pad`` first."""
    (t, b), (l, r) = conv_pads(x.shape[2:], w.shape[2:], strides, padding)
    if t == b and l == r:
        pad = (t, l)
    else:
        x = F.pad(x, (l, r, t, b))
        pad = 0
    return F.conv2d(x, w, bias, strides, pad, 1, groups)


class QuantEmbed(nn.Module):
    """Embedding with an LSQ weight-quantized table (per-row qparams: the
    per-channel axis is 0, the vocab axis).

    QAT mode: an ``nn.Parameter`` table, fake-quantized whole by
    ``weight_fq``, then the rows gathered with ``F.embedding`` (its CUDA
    backward sums the rows' gradients without atomics, so a step's result
    does not depend on the run).  Serve mode: an int8 table (always 8 bit: a
    row gather needs whole bytes) with per-row (or per-tensor) qparams; only
    the gathered rows are dequantized."""

    def __init__(self, num_embeddings: int, features: int, qconfig: QConfig, *,
                 path: Sequence[str] = (), device=None):
        super().__init__()
        qc = qconfig.resolve(tuple(path))
        self.qat = qc.mode != "serve"
        if self.qat:
            device = resolve_device(device)
            self.embedding = nn.Parameter(torch.zeros(num_embeddings, features,
                                                      device=device))
            self.weight_fq = _fake_quantizer(qc.weight_for_axis(0), num_embeddings,
                                             device)
            return
        wspec = qc.required_weight_for_axis(0).spec
        c = num_embeddings if wspec.per_channel else 1
        self.embedding = _PackedBuffers((num_embeddings, features), 8, 0, 0, c,
                                        resolve_device(device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.qat:
            return qat_embed(self, tokens, self.embedding)
        p = self.embedding
        rows = p.data[tokens].to(torch.float32)
        if p.scale.shape[0] > 1:
            s = p.scale[tokens][..., None]
            z = p.zero_point[tokens][..., None]
        else:
            s, z = p.scale, p.zero_point
        return (rows - z.to(torch.float32)) * s


def qat_embed(mod: nn.Module, tokens: torch.Tensor, table: torch.Tensor,
              padding_idx: Optional[int] = None) -> torch.Tensor:
    """The QAT lookup of ``QuantEmbed`` and ``quantize_model``'s
    ``QuantEmbedding``: the whole ``table`` through ``mod.weight_fq`` (per
    row), then the rows gathered."""
    if mod.weight_fq is not None:
        table = mod.weight_fq(table)
    return F.embedding(tokens, table, padding_idx)
