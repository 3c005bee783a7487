"""ctypes wrappers over the host C++ oracle (port of ``jaxlsq/native/ops.py``):
numpy in, numpy out.

They mirror the port's golden functions (``jaxlsq_torch/core/golden.py``):
the same (x, scale, shift, spec) signature, the same reduced (dX, dS, dB)
outputs and the same grad-scale resolution (``effective_grad_scale``), so
the two oracles, and the card's fake-quant kernels, can be held against each
other.  The backward's dS/dB are summed in double per thread and folded in
the order the OpenMP threads finish.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..core.golden import effective_grad_scale
from ..core.spec import QuantSpec
from .build import load_library

__all__ = ["native_forward", "native_backward", "native_quantize_i8"]


class _LsqParams(ctypes.Structure):
    _fields_ = [
        ("qmin", ctypes.c_double),
        ("qmax", ctypes.c_double),
        ("tmin", ctypes.c_double),
        ("tmax", ctypes.c_double),
        ("grad_scaler", ctypes.c_double),
        ("symmetric", ctypes.c_int32),
        ("eval_mode", ctypes.c_int32),
        ("init_mode", ctypes.c_int32),
    ]


def _layout(x: np.ndarray, spec: QuantSpec) -> Tuple[int, int, int]:
    """(n, channels, inner) for the channel(i) = (i / inner) % C convention."""
    if not spec.per_channel:
        return x.size, 1, 1
    axis = spec.axis % x.ndim
    inner = int(np.prod(x.shape[axis + 1:], dtype=np.int64))
    return x.size, x.shape[axis], max(inner, 1)


_P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {  # x (or grad, x), scale, shift, outputs..., n, C, inner, params
    "lsq_forward_f32": [_P, _P, _P, _P],
    "lsq_backward_f32": [_P, _P, _P, _P, _P, _P, _P],
    "lsq_quantize_i8": [_P, _P, _P, ctypes.POINTER(ctypes.c_int8)],
}


def _lib() -> ctypes.CDLL:
    lib = load_library()
    for name, ptrs in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ptrs + [ctypes.c_int64] * 3 + [ctypes.POINTER(_LsqParams)]
            fn.restype = None
    return lib


def _params(spec: QuantSpec, gs: float, eval_mode: bool, init_mode: bool) -> _LsqParams:
    return _LsqParams(
        qmin=float(spec.quant_min), qmax=float(spec.quant_max),
        tmin=float(spec.type_min), tmax=float(spec.type_max),
        grad_scaler=float(gs), symmetric=int(spec.symmetric),
        eval_mode=int(eval_mode), init_mode=int(init_mode))


def _f32c(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _qparams(scale, shift, c: int):
    return (np.broadcast_to(_f32c(scale), (c,)).copy(),
            np.broadcast_to(_f32c(shift), (c,)).copy())


def native_forward(x: np.ndarray, scale: np.ndarray, shift: np.ndarray,
                   spec: QuantSpec, *, init_mode: bool = False) -> np.ndarray:
    """The fake-quant forward of ``x`` (any shape, f32)."""
    lib = _lib()
    x = _f32c(x)
    n, c, inner = _layout(x, spec)
    scale, shift = _qparams(scale, shift, c)
    out = np.empty_like(x)
    p = _params(spec, 1.0, False, init_mode)
    lib.lsq_forward_f32(_ptr(x), _ptr(scale), _ptr(shift), _ptr(out),
                        ctypes.c_int64(n), ctypes.c_int64(c), ctypes.c_int64(inner),
                        ctypes.byref(p))
    return out


def native_backward(grad: np.ndarray, x: np.ndarray, scale: np.ndarray,
                    shift: np.ndarray, spec: QuantSpec, *, eval_mode: bool = False,
                    init_mode: bool = False, numel: Optional[int] = None):
    """(dX, dS, dB) of the fake-quant backward; dS/dB are (C,) per channel
    and the qparams' own shape per tensor, as ``golden_backward``'s."""
    lib = _lib()
    grad, x = _f32c(grad), _f32c(x)
    n, c, inner = _layout(x, spec)
    scale_b, shift_b = _qparams(scale, shift, c)
    dx = np.empty_like(x)
    ds = np.zeros((c,), np.float32)
    db = np.zeros((c,), np.float32)
    gs = effective_grad_scale(spec, numel if numel is not None else x.size, c)
    p = _params(spec, gs, eval_mode, init_mode)
    lib.lsq_backward_f32(_ptr(grad), _ptr(x), _ptr(scale_b), _ptr(shift_b), _ptr(dx),
                         _ptr(ds), _ptr(db), ctypes.c_int64(n), ctypes.c_int64(c),
                         ctypes.c_int64(inner), ctypes.byref(p))
    if c > 1:
        return dx, ds, db
    qshape = np.asarray(scale).shape
    return dx, ds[:1].reshape(qshape), db[:1].reshape(qshape)


def native_quantize_i8(w: np.ndarray, scale: np.ndarray, shift: np.ndarray,
                       spec: QuantSpec) -> np.ndarray:
    """``round(clamp(w / s + zp, qmin, qmax))`` as int8 (the serving pack's
    integers)."""
    lib = _lib()
    w = _f32c(w)
    n, c, inner = _layout(w, spec)
    scale, shift = _qparams(scale, shift, c)
    out = np.empty(w.shape, np.int8)
    p = _params(spec, 1.0, False, False)
    lib.lsq_quantize_i8(_ptr(w), _ptr(scale), _ptr(shift),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                        ctypes.c_int64(n), ctypes.c_int64(c), ctypes.c_int64(inner),
                        ctypes.byref(p))
    return out
