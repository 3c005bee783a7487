"""jaxlsq_torch: the PyTorch + CUDA port of jaxlsq (LSQ/LSQ+ quantization).

* LSQ QAT training: ``ops`` (the fake-quant kernels, static, traced and
  fused, ``fake_quant``/``lsq`` with their custom backward, the
  flash-attention kernels), ``observers`` (min/max observers, the quantizer
  state machine), ``models`` (QAT ``QuantDense``, ``QuantConv``,
  ``QuantEmbed``, flax-rule ``BatchNorm``, ``QuantResNet``/``resnet18_cifar``,
  the QAT-mode LM) and ``parallel`` (``make_train_step``, eager or captured
  as one CUDA graph, ``make_eval_step``);
* serving ``QuantTransformerLM`` with int8/int4 weight-only matmuls and
  KV-cache decode: ``serve`` (pack, convert, the ``wo_matmul`` and
  attention kernels as ``torch.library`` operators, ``make_generate``,
  ``DecodeEngine``, the paged cache and ``PagedDecodeEngine``, the
  ``torch.export`` of serving programs);
* ``utils`` (reports, sensitivity and mixed-precision planning, profiling,
  torchlsq migration, BatchNorm re-estimation, checkpoints), ``native`` (the
  host C++ oracle and shard loader) and ``lab`` (the int4 kernel lab's
  candidates, the accuracy protocol);

and ``interop``, which carries JAX package variables trees across.  The
kernels are CUDA C++ for sm_90a in ``csrc/``, built at first use; on CPU
tensors every kernel wrapper runs its plain PyTorch version.  Nothing here
imports jax or the jaxlsq package.

The subpackages and the names below are imported on first use, so a
process can import ``jaxlsq_torch.serve.custom_ops`` (to load an exported
program) without the model classes.
"""

import importlib

_SUBMODULES = ("core", "interop", "models", "observers", "ops", "parallel", "serve")
_NAMES = {"QuantSpec": "core", "QConfig": "models", "QuantResNet": "models",
          "QuantTransformerLM": "models", "default_qconfig": "models",
          "init_variables": "models", "resnet18_cifar": "models", "fake_quant": "ops",
          "lsq": "ops", "make_eval_step": "parallel", "make_train_step": "parallel"}

__all__ = list(_SUBMODULES) + list(_NAMES)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _NAMES:
        return getattr(importlib.import_module(f".{_NAMES[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
