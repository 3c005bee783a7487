"""jaxlsq_torch: the PyTorch + CUDA port of jaxlsq (LSQ/LSQ+ quantization).

This slice serves ``QuantTransformerLM`` with int8/int4 weight-only matmuls
and KV-cache decode: ``models`` (QConfig, serve-mode layers, the LM),
``serve`` (pack, convert, the ``wo_matmul`` and ``decode_attention`` kernels,
``make_generate``, ``DecodeEngine``) and ``interop`` (load a JAX package
variables tree).  The kernels are CUDA C++ for sm_90a in ``csrc/``, built at
first use; on CPU tensors every kernel wrapper runs its plain PyTorch version.
Nothing here imports jax or the jaxlsq package.
"""

from . import core, interop, models, observers, serve
from .core import QuantSpec
from .models import QConfig, QuantTransformerLM, default_qconfig, init_variables

__all__ = ["core", "interop", "models", "observers", "serve", "QuantSpec",
           "QConfig", "QuantTransformerLM", "default_qconfig", "init_variables"]
