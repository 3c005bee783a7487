"""QConfig: per-layer quantizer configuration (port of ``jaxlsq/models/qconfig.py``).

A frozen dataclass pairing two :class:`LSQQuantizer` templates, with the same
execution-mode fields (``mode``, ``act_mode``) and mixed-precision overrides.
The JAX package's ``serve_impl``/``serve_precision`` fields pick between XLA
and Pallas on the TPU; the port has one path per device (kernel on CUDA, plain
PyTorch on the CPU), so they have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.spec import QuantSpec
from ..observers.histogram import HistogramObserver
from ..observers.minmax import MSEObserver, PercentileObserver
from ..observers.quantizer import LSQQuantizer

__all__ = ["QConfig", "default_qconfig"]


@dataclasses.dataclass(frozen=True)
class QConfig:
    """``weight`` and ``activation`` quantizer templates plus execution mode.

    ``mode``: 'qat' or 'serve'.  ``act_mode`` (serve): 'none' (weight-only),
    'static' (frozen fake-quant of the input with the converted qparams),
    'static_int8' (the int8 x int8 product with the converted per-tensor
    activation qparams) or 'dynamic' (per-tensor activation quantization
    from each call's max|x|, dense layers only).  ``overrides``: ``(pattern, QConfig)`` pairs;
    the first pattern found in a layer's '/'-joined path wins.
    """

    weight: Optional[LSQQuantizer] = None
    activation: Optional[LSQQuantizer] = None
    mode: str = "qat"
    act_mode: str = "none"
    overrides: tuple = ()

    def for_serving(self, act_mode: str = "none") -> "QConfig":
        """The serving twin of this config (same specs, serve-mode layers)."""
        if act_mode not in ("none", "static", "static_int8", "dynamic"):
            raise ValueError(f"unknown act_mode {act_mode!r}")
        return dataclasses.replace(self, mode="serve", act_mode=act_mode)

    def with_overrides(self, mapping) -> "QConfig":
        """Mixed-precision config: ``{path_pattern: QConfig}``, first match wins."""
        pairs = tuple((str(k), v) for k, v in mapping.items())
        for _, qc in pairs:
            if not isinstance(qc, QConfig):
                raise ValueError("override values must be QConfig instances")
        return dataclasses.replace(self, overrides=pairs)

    def resolve(self, path) -> "QConfig":
        """The effective config for a module at ``path`` (tuple of names or a
        string), under THIS config's execution mode."""
        if not self.overrides:
            return self
        joined = path if isinstance(path, str) else "/".join(str(p) for p in path)
        for pattern, qc in self.overrides:
            if pattern in joined:
                return dataclasses.replace(qc, mode=self.mode,
                                           act_mode=self.act_mode, overrides=())
        return dataclasses.replace(self, overrides=())

    def required_weight_for_axis(self, axis: int) -> LSQQuantizer:
        """weight_for_axis that raises when there is nothing packed to serve."""
        wcfg = self.weight_for_axis(axis)
        if wcfg is None:
            raise ValueError(
                "serve mode requires a weight quantizer; qconfig.weight is "
                "None (weight-unquantized layers have no packed kernel/table)")
        return wcfg

    def weight_for_axis(self, axis: int) -> Optional[LSQQuantizer]:
        if self.weight is None:
            return None
        if not self.weight.spec.per_channel:
            return self.weight
        return dataclasses.replace(self.weight, spec=self.weight.spec.replace(axis=axis))

    def activation_for_axis(self, axis: int) -> Optional[LSQQuantizer]:
        if self.activation is None:
            return None
        if not self.activation.spec.per_channel:
            return self.activation
        return dataclasses.replace(
            self.activation, spec=self.activation.spec.replace(axis=axis))


def default_qconfig(
    weight_bits: int = 8,
    act_bits: int = 8,
    *,
    per_channel_weights: bool = False,
    init_batches: int = 1000,
    init_mode: str = "observer",
    act_observer: str = "minmax",
    reduce_range: bool = True,
    learn_params: bool = True,
) -> QConfig:
    """Symmetric signed weights + affine unsigned activations, optionally
    range-narrowed by one bit, observer- or learnable-init activations over
    ``init_batches``.  ``act_observer``: 'minmax' (a moving-average min/max),
    'mse' (the MSE-minimizing range search, given the activation spec),
    'histogram' (torch.ao's running histogram and its range search) or
    'percentile' (the 99.99th-percentile range)."""
    aspec = QuantSpec.activation_default(act_bits, reduce_range=reduce_range)
    if act_observer == "mse":
        obs = MSEObserver(spec=aspec, per_channel=aspec.per_channel, axis=aspec.axis)
    elif act_observer == "histogram":
        obs = HistogramObserver()
    elif act_observer == "percentile":
        obs = PercentileObserver(per_channel=aspec.per_channel, axis=aspec.axis)
    elif act_observer == "minmax":
        obs = None
    else:
        raise ValueError(f"unknown act_observer {act_observer!r}")
    wq = LSQQuantizer(
        spec=QuantSpec.weight_default(weight_bits, per_channel=per_channel_weights,
                                      axis=0, reduce_range=reduce_range),
        otype="weight",
        learn_params=learn_params,
    )
    aq = LSQQuantizer(
        spec=aspec,
        otype="activation",
        init_mode=init_mode,
        n_batches=init_batches,
        observer=obs,
        learn_params=learn_params,
    )
    return QConfig(weight=wq, activation=aq)
