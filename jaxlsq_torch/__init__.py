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
  attention kernels, ``make_generate``, ``DecodeEngine``, the paged cache and
  ``PagedDecodeEngine``);
* ``lab``: the int4 kernel lab's candidate kernels, timed beside the
  shipped ones;

and ``interop``, which carries JAX package variables trees across.  The
kernels are CUDA C++ for sm_90a in ``csrc/``, built at first use; on CPU
tensors every kernel wrapper runs its plain PyTorch version.  Nothing here
imports jax or the jaxlsq package.
"""

from . import core, interop, models, observers, ops, parallel, serve
from .core import QuantSpec
from .models import (QConfig, QuantResNet, QuantTransformerLM, default_qconfig,
                     init_variables, resnet18_cifar)
from .ops import fake_quant, lsq
from .parallel import make_eval_step, make_train_step

__all__ = ["core", "interop", "models", "observers", "ops", "parallel", "serve",
           "QuantSpec", "QConfig", "QuantResNet", "QuantTransformerLM",
           "default_qconfig", "init_variables", "resnet18_cifar", "fake_quant",
           "lsq", "make_eval_step", "make_train_step"]
