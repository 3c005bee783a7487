"""The serving kernels as ``torch.library`` operators in the ``jaxlsq_torch``
namespace, so that ``torch.export`` can trace a served model (a ``ctypes``
launch on ``data_ptr()`` cannot be traced).

* ``jaxlsq_torch::wo_matmul``: the weight-only matmul (``wo8``, ``wo4``,
  ``wo4g``; ``serve.matmul``);
* ``jaxlsq_torch::decode_attention``: attention over the dense KV cache
  (``serve.attention``);
* ``jaxlsq_torch::act_quant_i8`` and ``jaxlsq_torch::i8mm``: the int8 x int8
  path's activation quantization and epilogue-fused product
  (``serve.matmul``);
* ``jaxlsq_torch::i8mm_fused``: the two in one, the product quantizing its
  activation rows itself (a static or dynamic matmul, or the experts'
  batched product, at decode M; ``serve.matmul.i8mm_plan``).

Each operator has a CUDA implementation (the kernel's launcher, which counts
its launch in the module's ``LAUNCHES``), a CPU implementation (the kernel's
plain PyTorch version) and a fake one (shapes and dtypes only, for tracing).
The dispatcher picks by the tensors' device: a CUDA tensor never reaches a
plain version.  The wrappers in ``serve.matmul`` and ``serve.attention``
check their arguments and call these operators while a program is traced
(``torch.compiler.is_compiling()``, true under ``torch.export``); eager code
calls the same implementations directly, without the dispatcher's boxed
call into Python (13-15% of a B = 1 decode token, PERF.md).

Importing this module registers the operators; it imports no model class,
so a process that loads an exported serving program needs only ``torch``
and this module.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from . import attention as _attention
from . import matmul as _matmul
from .pack import PackedWeight

__all__ = ["NAMESPACE"]

NAMESPACE = "jaxlsq_torch"

_lib = torch.library.Library(NAMESPACE, "DEF")
_lib.define("wo_matmul(Tensor x, Tensor data, Tensor scale, Tensor zero_point, int bits, "
            "int axis, int k_axis, int k, int n, int group_size) -> Tensor")
_lib.define("decode_attention(Tensor q, Tensor kd, Tensor? ks, Tensor vd, Tensor? vs, "
            "Tensor qpos, int window) -> Tensor")
_lib.define("act_quant_i8(Tensor x, Tensor? act_scale, Tensor? act_zp, int act_qmin, "
            "int act_qmax, bool dynamic) -> (Tensor, Tensor)")
_lib.define("i8mm(Tensor a, Tensor b, Tensor qx, Tensor scale, Tensor zero_point, str mode, "
            "int q_bstride, int q_nstride, float window, int[] conv_out) -> Tensor")
_lib.define("i8mm_fused(Tensor x, Tensor b, Tensor scale, Tensor zero_point, Tensor? act_scale, "
            "Tensor? act_zp, int act_qmin, int act_qmax, bool dynamic, int q_bstride, "
            "int q_nstride) -> Tensor")


def _register(name: str, cpu, cuda, fake) -> None:
    _lib.impl(name, cpu, "CPU")
    _lib.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_lib)


# ----------------------------------------------------------------- wo_matmul

def _wo_cpu(x, data, scale, zero_point, bits, axis, k_axis, k, n, group_size):
    return _matmul.wo_matmul_plain(x, PackedWeight(
        data, scale, zero_point, bits=bits, axis=axis, k_axis=k_axis, orig_shape=(k, n),
        group_size=group_size or None))


def _wo_cuda(x, data, scale, zero_point, bits, axis, k_axis, k, n, group_size):
    return _matmul._wo_launch(x, data, scale, zero_point, bits, k, n, group_size)


def _wo_fake(x, data, scale, zero_point, bits, axis, k_axis, k, n, group_size):
    return x.new_empty((*x.shape[:-1], n), dtype=torch.float32)


_register("wo_matmul", _wo_cpu, _wo_cuda, _wo_fake)


# ---------------------------------------------------------- decode_attention

def _caches(kd, ks, vd, vs):
    return ((kd, ks), (vd, vs)) if ks is not None else (kd, vd)


def _attn_cpu(q, kd, ks, vd, vs, qpos, window):
    ck, cv = _caches(kd, ks, vd, vs)
    return _attention.decode_attention_plain(q, ck, cv, qpos, window or None).contiguous()


def _attn_cuda(q, kd, ks, vd, vs, qpos, window):
    ck, cv = _caches(kd, ks, vd, vs)
    return _attention._launch(q, ck, cv, qpos, window or None)


def _attn_fake(q, kd, ks, vd, vs, qpos, window):
    return torch.empty_like(q, dtype=torch.float32, memory_format=torch.contiguous_format)


_register("decode_attention", _attn_cpu, _attn_cuda, _attn_fake)


# -------------------------------------------------------------- act_quant_i8

def _aq_cpu(x, act_scale, act_zp, act_qmin, act_qmax, dynamic):
    return _matmul.act_quant_i8_plain(x, act_scale, act_zp, act_qmin, act_qmax,
                                      dynamic=dynamic)


def _aq_cuda(x, act_scale, act_zp, act_qmin, act_qmax, dynamic):
    return _matmul._act_quant_i8_launch(x, act_scale, act_zp, act_qmin, act_qmax, dynamic)


def _aq_fake(x, act_scale, act_zp, act_qmin, act_qmax, dynamic):
    return (torch.empty_like(x, dtype=torch.int8, memory_format=torch.contiguous_format),
            x.new_empty((2,), dtype=torch.float32))


_register("act_quant_i8", _aq_cpu, _aq_cuda, _aq_fake)


# ---------------------------------------------------------------------- i8mm

def _geom(conv_out: List[int]) -> Optional[tuple]:
    return tuple(conv_out) if conv_out else None


def _i8mm_cpu(a, b, qx, scale, zero_point, mode, q_bstride, q_nstride, window, conv_out):
    return _matmul._i8mm(a, b, qx, scale, zero_point, mode, (q_bstride, q_nstride),
                         plain=True, window=window, conv_out=_geom(conv_out))


def _i8mm_cuda(a, b, qx, scale, zero_point, mode, q_bstride, q_nstride, window, conv_out):
    return _matmul._i8mm(a, b, qx, scale, zero_point, mode, (q_bstride, q_nstride),
                         plain=False, window=window, conv_out=_geom(conv_out))


def _i8mm_fake(a, b, qx, scale, zero_point, mode, q_bstride, q_nstride, window, conv_out):
    batch, m, _ = a.shape
    n = b.shape[2]
    if conv_out:
        imgs, ho, wo = conv_out
        return a.new_empty((imgs, batch * n, ho, wo), dtype=torch.float32)
    return a.new_empty((batch, m, n), dtype=torch.float32)


_register("i8mm", _i8mm_cpu, _i8mm_cuda, _i8mm_fake)


# ---------------------------------------------------------------- i8mm_fused

def _fused_cpu(x, b, scale, zero_point, act_scale, act_zp, act_qmin, act_qmax, dynamic,
               q_bstride, q_nstride):
    return _matmul._quantized_product(x, b, scale, zero_point, act_scale, act_zp, act_qmin,
                                      act_qmax, dynamic, (q_bstride, q_nstride), True)


def _fused_cuda(x, b, scale, zero_point, act_scale, act_zp, act_qmin, act_qmax, dynamic,
                q_bstride, q_nstride):
    # the plan of the card it runs on: fused, or act_quant_i8 then i8mm
    return _matmul._quantized_product(x, b, scale, zero_point, act_scale, act_zp, act_qmin,
                                      act_qmax, dynamic, (q_bstride, q_nstride), False)


def _fused_fake(x, b, scale, zero_point, act_scale, act_zp, act_qmin, act_qmax, dynamic,
                q_bstride, q_nstride):
    return x.new_empty((x.shape[0], x.shape[1], b.shape[2]), dtype=torch.float32)


_register("i8mm_fused", _fused_cpu, _fused_cuda, _fused_fake)
