"""LSQ quantizer: configuration, phase state machine and the qparam handoff
to serving (port of ``jaxlsq/observers/quantizer.py``).

:class:`LSQQuantizer` is the static configuration; :class:`QuantizerState`
its runtime state, and every mode switch returns a new state, as in the JAX
package.  scale/shift and the observer's range and count are device
tensors.  The phase counters and flags (``STATE_FIELDS``) take one of two
forms, and the form picks the regime, as tracers pick it in the JAX package:

* host values (ints and bools): the concrete (eager) regime, the
  reference's control flow, whose phase decisions never wait for the card::

    forward(x, training):
      debug_mode -> x
      do_backprop_init = False; do_full_lsq = learning_enabled
      if training and learning_enabled and current_batch <= n_batches:
          'observer':  do_full_lsq = (current_batch == n_batches);
                       on that last batch also disable_observer()
          'learnable': disable_observer();
                       do_backprop_init = (current_batch != n_batches)
          current_batch += 1
      if observer_enabled: update the observer on x;
                           scale, zp = observer qparams; shift = -zp * scale
      if fake_quant_enabled:
          out = fake_quant(x, scale, shift, eval=not do_full_lsq,
                           init=do_backprop_init and do_full_lsq)
      else: out = x

* () device tensors (int32 counters, bool flags; ``QuantizerState.on_device``):
  the traced regime, the same decisions as ``torch.where`` on device values,
  the observer handed ``observer_enabled`` as the gate that an expensive
  one's kernels read on the card (the JAX package's ``lax.cond``; the
  min/max update ignores it) and its result where-merged, and
  ``fake_quant_traced`` with the modes as device flags.  No host branch and
  no host read, so one captured CUDA graph covers the observer window, the
  switch to LSQ and any toggle.

Weights get ``n_batches = -1`` (the window never opens) and a static
mean ± 3σ scale.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from .. import _dist
from ..core.spec import QuantSpec
from ..ops.functional import fake_quant, fake_quant_traced
from .histogram import HistogramObserver, HistogramObserverState
from .minmax import (MinMaxObserver, MovingAverageMinMaxObserver, MSEObserver,
                     ObserverState, PercentileObserver)

__all__ = ["LSQQuantizer", "QuantizerState", "convert_shift_to_zp",
           "STATE_FIELDS", "STATE_DTYPES"]

# The phase counters and flags, in the order of the JAX package's
# quant_state, and their device types there.
STATE_FIELDS = ("current_batch", "n_batches", "fake_quant_enabled",
                "observer_enabled", "learning_enabled")
STATE_DTYPES = {"current_batch": torch.int32, "n_batches": torch.int32,
                "fake_quant_enabled": torch.bool, "observer_enabled": torch.bool,
                "learning_enabled": torch.bool}


Observer = Union[MinMaxObserver, MSEObserver, PercentileObserver, HistogramObserver]
ObsState = Union[ObserverState, HistogramObserverState]


def _where_state(cond: torch.Tensor, new: ObsState, old: ObsState) -> ObsState:
    """Each field of the observer state ``new`` where ``cond``, else ``old``'s."""
    return dataclasses.replace(old, **{
        f.name: torch.where(cond, getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(old)})


def convert_shift_to_zp(shift: torch.Tensor, scale: torch.Tensor,
                        spec: QuantSpec) -> torch.Tensor:
    """zero_point = round(clamp(-shift/scale, tmin, tmax)) as int32."""
    zp = torch.round(torch.clamp(-shift / scale, spec.type_min, spec.type_max))
    return zp.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class QuantizerState:
    """Runtime state of one quantizer: (C,) scale/shift and the observer
    state on the device; the phase counters and flags as host values
    (concrete regime) or () device tensors (traced regime)."""

    scale: torch.Tensor
    shift: torch.Tensor
    current_batch: Union[int, torch.Tensor]
    n_batches: Union[int, torch.Tensor]   # -1: the init window never opens
    fake_quant_enabled: Union[bool, torch.Tensor]
    observer_enabled: Union[bool, torch.Tensor]
    learning_enabled: Union[bool, torch.Tensor]
    obs: ObsState

    def replace(self, **kw) -> "QuantizerState":
        return dataclasses.replace(self, **kw)

    @property
    def traced(self) -> bool:
        return torch.is_tensor(self.current_batch)

    def on_device(self) -> "QuantizerState":
        """This state in the traced regime: counters and flags as () tensors
        of the JAX package's types on scale's device."""
        return self.replace(**{
            f: torch.as_tensor(getattr(self, f), dtype=STATE_DTYPES[f],
                               device=self.scale.device).reshape(())
            for f in STATE_FIELDS})


@dataclasses.dataclass(frozen=True)
class LSQQuantizer:
    """Static configuration of one LSQ/LSQ+ fake-quantizer.

    ``otype`` is 'weight' (static mean ± 3σ scale init, symmetric spec
    required) or 'activation' (``init_scale``/``init_shift``, with the shift
    overridden by the symmetric rule for symmetric specs).  ``init_mode``
    'observer' runs ``observer`` (a moving-average min/max by default) over
    the first ``n_batches`` training batches; 'learnable' trains the qparams
    from the start with LSQ+ backprop init over that window.  ``numel``
    overrides the element count of the gradient scale.
    """

    spec: QuantSpec
    otype: str = "activation"
    init_mode: str = "observer"
    n_batches: int = 1000
    init_scale: float = 1.0
    init_shift: float = 0.0
    observer: Optional[Observer] = None
    learn_params: bool = True
    debug_mode: bool = False
    numel: Optional[int] = None

    def __post_init__(self):
        if self.otype not in ("weight", "activation"):
            raise ValueError(f"otype must be 'weight' or 'activation', got {self.otype}")
        if self.init_mode not in ("observer", "learnable"):
            raise ValueError(
                f"init_mode must be 'observer' or 'learnable', got {self.init_mode}")
        if self.otype == "weight" and not self.spec.symmetric:
            raise ValueError("weight quantizers must use a symmetric spec")
        if (self.observer is None and self.init_mode == "observer"
                and self.otype == "activation"):
            object.__setattr__(self, "observer", MovingAverageMinMaxObserver(
                per_channel=self.spec.per_channel, axis=self.spec.axis))

    @property
    def effective_init_shift(self) -> float:
        if self.spec.symmetric:
            return self.spec.symmetric_init_shift(self.init_scale)
        return self.init_shift

    def grad_numel(self, x: torch.Tensor) -> Optional[int]:
        """The element count of the gradient scale: ``numel`` when set, else
        under a split of the rows (``_dist.current()``) the global count of
        an activation (and of an expert-parallel weight), each split's size
        counted unless it splits this quantizer's own channel axis (the
        per-channel ``/ C`` then shrinks with it); else None (x's own)."""
        split = _dist.current()
        if self.numel is not None or split is None:
            return self.numel
        if self.otype == "weight" and not split.weights:
            return None
        axis = self.spec.axis % x.dim() if self.spec.per_channel else None
        n = x.numel()
        for p in split.parts:
            if p.dim != axis:
                n *= p.size
        return n

    # ------------------------------------------------------------------ init

    def init(self, x: Optional[torch.Tensor] = None, *,
             num_channels: Optional[int] = None, device=None) -> QuantizerState:
        """A complete initial state on ``device`` (default: x's device).  For
        weights, ``x`` drives the static init ``max(|µ−3σ|, |µ+3σ|) /
        2**bitness`` with Bessel-corrected σ and ``bitness = ceil(log2(qmax −
        qmin)) − 1``."""
        if not self.spec.per_channel:
            c = 1
        elif x is not None:
            c = x.shape[self.spec.axis]
        elif num_channels is not None:
            c = num_channels
        else:
            raise ValueError("per-channel quantizer init needs x or num_channels")
        if device is None:
            if x is None:
                raise ValueError("quantizer init needs x or a device")
            device = x.device
        scale = torch.full((c,), self.init_scale, dtype=torch.float32, device=device)
        if self.otype == "weight" and x is not None:
            xd = x.detach().to(device=device, dtype=torch.float32)
            bitness = math.ceil(
                math.log2(self.spec.quant_max - self.spec.quant_min)) - 1
            if self.spec.per_channel:
                axis = self.spec.axis % x.dim()
                red = tuple(a for a in range(x.dim()) if a != axis)
                mean = xd.mean(dim=red)
                std = xd.std(dim=red, correction=1)
            else:
                mean = xd.mean().reshape(1)
                std = xd.std(correction=1).reshape(1)
            scale = torch.maximum((mean - 3 * std).abs(),
                                  (mean + 3 * std).abs()) / 2 ** bitness
        shift = torch.full((c,), self.effective_init_shift, dtype=torch.float32,
                           device=device)
        obs = (self.observer.init(c, device) if self.observer is not None
               else ObserverState(torch.zeros(c, device=device),
                                  torch.zeros(c, device=device),
                                  torch.zeros((), dtype=torch.int32, device=device)))
        state = QuantizerState(
            scale=scale, shift=shift, current_batch=0,
            n_batches=-1 if self.otype == "weight" else self.n_batches,
            fake_quant_enabled=True, observer_enabled=True,
            learning_enabled=bool(self.learn_params), obs=obs)
        return self.enable_observer(state)

    # --------------------------------------------------------- mode switches

    def enable_observer(self, state: QuantizerState) -> QuantizerState:
        """Enable, then gate off where the observer is not needed."""
        learning = state.learning_enabled
        if self.otype == "weight" or self.init_mode == "learnable":
            enabled = not learning
        else:
            enabled = not (learning and state.current_batch > state.n_batches)
        return state.replace(observer_enabled=enabled)

    def disable_observer(self, state: QuantizerState) -> QuantizerState:
        return state.replace(observer_enabled=False)

    def enable_fake_quant(self, state: QuantizerState) -> QuantizerState:
        return state.replace(fake_quant_enabled=True)

    def disable_fake_quant(self, state: QuantizerState) -> QuantizerState:
        return state.replace(fake_quant_enabled=False)

    def enable_param_learning(self, state: QuantizerState) -> QuantizerState:
        """Learn via LSQ: no observer, no init window."""
        return state.replace(learning_enabled=True, observer_enabled=False,
                             n_batches=-1)

    def enable_static_estimate(self, state: QuantizerState) -> QuantizerState:
        """A plain FakeQuantize driven by the observer."""
        return self.enable_observer(state.replace(learning_enabled=False))

    # --------------------------------------------------------------- qparams

    def set_qparams(self, state: QuantizerState, scale=None, shift=None,
                    zero_point=None) -> QuantizerState:
        """New scale and/or shift; a zero point becomes ``shift = −zp·scale``
        with the (possibly new) scale."""
        def as_f32(v, like):
            return torch.as_tensor(v, dtype=torch.float32,
                                   device=like.device).reshape(like.shape)

        new_scale = state.scale if scale is None else as_f32(scale, state.scale)
        new_shift = state.shift
        if zero_point is not None:
            new_shift = -as_f32(zero_point, state.shift) * new_scale
        if shift is not None:
            new_shift = as_f32(shift, state.shift)
        return state.replace(scale=new_scale, shift=new_shift)

    def calculate_qparams(self, state: QuantizerState
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scale, int32 zero_point) for serving: eps-floored scale, shift→zp."""
        scale = torch.clamp_min(state.scale, torch.finfo(torch.float32).eps)
        return scale, convert_shift_to_zp(state.shift, scale, self.spec)

    # --------------------------------------------------------------- forward

    def advance(self, state: QuantizerState, x: torch.Tensor, training: bool
                ) -> Tuple[QuantizerState, Optional[Tuple[bool, bool]]]:
        """The phase bookkeeping and observer update of one forward.  Returns
        the new state and the fake-quant modes ``(eval_mode, init_mode)``, or
        None when fake quantization is off."""
        do_backprop_init = False
        do_full_lsq = state.learning_enabled
        if (training and state.learning_enabled
                and state.current_batch <= state.n_batches):
            if self.init_mode == "observer":
                do_full_lsq = state.current_batch == state.n_batches
                if do_full_lsq:
                    state = self.disable_observer(state)
            else:
                state = self.disable_observer(state)
                do_backprop_init = state.current_batch != state.n_batches
            state = state.replace(current_batch=state.current_batch + 1)
        if state.observer_enabled and self.observer is not None:
            obs = self.observer.update(state.obs, x)
            scale, zp = self.observer.calculate_qparams(obs, self.spec)
            state = self.set_qparams(state.replace(obs=obs), scale=scale,
                                     zero_point=zp)
        if not state.fake_quant_enabled:
            return state, None
        return state, (not do_full_lsq, do_backprop_init and do_full_lsq)

    def __call__(self, state: QuantizerState, x: torch.Tensor, *,
                 training: bool = False) -> Tuple[torch.Tensor, QuantizerState]:
        if self.debug_mode:
            return x, state
        if state.traced:
            return self.forward_traced(state, x, training)
        state, modes = self.advance(state, x, training)
        return self.quantize(x, state.scale, state.shift, modes), state

    def quantize(self, x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 modes, traced: bool = False) -> torch.Tensor:
        """``x`` fake-quantized with ``scale``/``shift`` in ``modes``: what
        :meth:`advance` returns (None: fake quantization off) or, ``traced``,
        what :meth:`advance_traced` returns."""
        if traced:
            eval_flag, init_flag, enabled = modes
            out = fake_quant_traced(x, scale, shift, self.spec, eval_flag=eval_flag,
                                    init_flag=init_flag, numel=self.grad_numel(x))
            return torch.where(enabled, out, x)
        if modes is None:
            return x
        return fake_quant(x, scale, shift, self.spec, eval_mode=modes[0],
                          init_mode=modes[1], numel=self.grad_numel(x))

    def forward_traced(self, state: QuantizerState, x: torch.Tensor,
                       training: bool) -> Tuple[torch.Tensor, QuantizerState]:
        """The traced regime (the JAX package's ``_forward_traced``): every
        phase decision is a device value.  A qparam the observer writes is
        ``where(observer_enabled, observer's, state's)``, so its gradient
        reaches the state's qparam only where the observer is off."""
        state, modes = self.advance_traced(state, x, training)
        return self.quantize(x, state.scale, state.shift, modes, traced=True), state

    def advance_traced(self, state: QuantizerState, x: torch.Tensor, training: bool
                       ) -> Tuple[QuantizerState, Tuple[torch.Tensor, ...]]:
        """The phase bookkeeping and observer update of :meth:`forward_traced`:
        the new state and the fake-quant flags ``(eval_flag, init_flag,
        fake_quant_enabled)``."""
        learning = state.learning_enabled
        cb, nb = state.current_batch, state.n_batches
        in_window = learning & (cb <= nb) & bool(training)
        if self.init_mode == "observer":
            do_full_lsq = torch.where(in_window, cb == nb, learning)
            obs_on = state.observer_enabled & ~(in_window & (cb == nb))
            do_backprop_init = torch.zeros_like(learning)
        else:
            do_full_lsq = learning
            obs_on = state.observer_enabled & ~in_window
            do_backprop_init = in_window & (cb != nb)
        state = state.replace(observer_enabled=obs_on,
                              current_batch=cb + in_window.to(cb.dtype))

        if self.observer is not None:
            # the JAX package's lax.cond: an expensive observer's kernels read
            # obs_on on the card and write nothing when it is off (the
            # percentile's sort runs anyway; the min/max update ignores the
            # gate), and the where-merge keeps the old state and qparams
            new = self.observer.update(state.obs, x, gate=obs_on)
            o_scale, o_zp = self.observer.calculate_qparams(new, self.spec, gate=obs_on)
            o_shift = -o_zp.to(torch.float32) * o_scale
            state = state.replace(obs=_where_state(obs_on, new, state.obs),
                                  scale=torch.where(obs_on, o_scale, state.scale),
                                  shift=torch.where(obs_on, o_shift, state.shift))

        do_backprop_init = do_backprop_init & do_full_lsq
        return state, (1.0 - do_full_lsq.to(torch.float32),
                       do_backprop_init.to(torch.float32), state.fake_quant_enabled)
