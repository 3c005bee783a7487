"""LSQ/LSQ+ fake-quant forward and backward kernels (port of
``jaxlsq/ops/pallas_kernels.py``: ``pallas_forward`` / ``pallas_backward``,
their traced-flag twins ``pallas_forward_traced`` /
``pallas_backward_traced``, and the fused ``pallas_fwdbwd``).

* On a CPU tensor each function runs its plain version, the golden math of
  ``core/golden.py``.
* On a CUDA tensor it launches ``csrc/fake_quant.cu`` (``fq_fwd_pt``,
  ``fq_fwd_pc``, ``fq_bwd_pt``, ``fq_bwd_pc``; traced: ``fq_fwd_pt_traced``,
  ``fq_fwd_pc_traced``, ``fq_bwd_pt_traced``, ``fq_bwd_pc_traced``; fused:
  ``fq_fwdbwd_pt``, ``fq_fwdbwd_pc``) or raises; there is no path from a
  CUDA tensor to the plain version.
* The kernels compute in f32.  A float16 or bfloat16 input (or qparam) is
  widened to f32 at the boundary, on either device, and the results are
  narrowed back: out and dX to the input's dtype (round to nearest even),
  dS/dB to the qparams' dtypes, as the JAX package's Pallas path reads 16-bit
  inputs as f32 and writes the input's dtype.  float64 runs the plain
  version on the CPU and is refused on the card.
* The static functions take the modes as host bools and skip what a mode
  does not need (no forward launch in init mode, no dS/dB in eval mode).
  The traced functions take them as ``flags``, a (2,) f32 device tensor
  ``[eval, init]`` read inside the kernels, and always launch and write
  every output, so a captured CUDA graph covers every phase.
* ``fake_quant_fwdbwd`` is the forward and the train-mode backward in one
  pass, for a caller that has the incoming gradient when it runs the
  forward (a recomputed forward, the fwd+bwd chain of ``chip_smoke.py``).

A per-channel tensor is handed to the kernels as its ``(outer, C, inner)``
view around ``spec.axis``, so the channel axis is never moved.  The qparams
stay on the device.  ``LAUNCHES`` counts the kernel launches of each kind.
Every backward is one launch with no workspace: per channel in the order
that :func:`pc_plan` fixes from the shape; per tensor its blocks' partials
folded by the block that finishes last, in the stream's slot of the
library's memory (:func:`_pt_slot`).
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Tuple

import torch

from .. import _build
from ..core.golden import (effective_grad_scale, golden_backward,
                           golden_backward_traced, golden_forward,
                           golden_forward_traced)
from ..core.spec import QuantSpec

__all__ = ["fake_quant_forward", "fake_quant_backward",
           "fake_quant_forward_traced", "fake_quant_backward_traced",
           "fake_quant_fwdbwd", "pc_plan", "LAUNCHES"]

LAUNCHES = {"fq_fwd_pt": 0, "fq_fwd_pc": 0, "fq_bwd_pt": 0, "fq_bwd_pc": 0,
            "fq_fwd_pt_traced": 0, "fq_fwd_pc_traced": 0,
            "fq_bwd_pt_traced": 0, "fq_bwd_pc_traced": 0,
            "fq_fwdbwd_pt": 0, "fq_fwdbwd_pc": 0}

_MAX_NUMEL = 2 ** 31 - 1  # the kernels index with 32-bit ints
_NARROW = (torch.float16, torch.bfloat16)
# The per-channel backward's plan (csrc/fake_quant.cu): a block is 8 warps.
# Runs: a channel takes more warps while a lane keeps at least one group of
# 4 elements, more blocks of a cluster while a lane keeps _CLUSTER_GROUPS.
# Rows: the rows go over more blocks of a cluster while a warp keeps
# _WARP_ROWS.  A cluster grows only while the blocks are fewer than _FILL.
# (Measured on the H100: sums over resnet18_cifar's weights and the LM's
# (K, N) weights, PERF.md §6.)
_BLOCK_WARPS, _MAX_CLUSTER = 8, 8
_CLUSTER_GROUPS, _WARP_ROWS, _FILL = 4, 4, 264


def _narrow(*ts: torch.Tensor) -> bool:
    return any(t.dtype in _NARROW for t in ts)


def _wide(*ts: torch.Tensor):
    return tuple(t.to(torch.float32) if t.dtype in _NARROW else t for t in ts)


def _view3(x: torch.Tensor, spec: QuantSpec) -> Tuple[int, int, int]:
    if not spec.per_channel:
        return 1, 1, x.numel()
    axis = spec.axis % x.dim()
    return (math.prod(x.shape[:axis]), x.shape[axis],
            math.prod(x.shape[axis + 1:]))


def _check_cuda(what: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    for t in (x,) + others:
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{what}: the CUDA kernels take float32 (16-bit inputs are "
                f"widened to it), got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: tensors on {t.device} and {x.device}")
    if x.numel() > _MAX_NUMEL:
        raise ValueError(f"{what}: {x.numel()} elements exceed the kernels' "
                         "32-bit indexing")


def _qparams(scale, shift, c: int, what: str):
    scale, shift = scale.contiguous(), shift.contiguous()
    if scale.numel() != c or shift.numel() != c:
        raise ValueError(f"{what}: qparams must have {c} elements, got "
                         f"{scale.numel()}/{shift.numel()}")
    return scale, shift


def _checked_pair(what: str, grad: torch.Tensor, x: torch.Tensor,
                  scale: torch.Tensor, shift: torch.Tensor, spec: QuantSpec):
    """A backward's inputs on the card, checked and contiguous, and x's
    ``(outer, C, inner)`` view."""
    _check_cuda(what, x, grad, scale, shift)
    if grad.shape != x.shape:
        raise ValueError(f"{what}: grad {tuple(grad.shape)} != x {tuple(x.shape)}")
    dims = _view3(x, spec)
    scale, shift = _qparams(scale, shift, dims[1], what)
    return grad.contiguous(), x.contiguous(), scale, shift, dims


def pc_plan(outer: int, c: int, inner: int) -> Tuple[int, int]:
    """``(warps, cluster)`` of the per-channel backward over the ``(outer,
    c, inner)`` view, from the shape alone; it fixes which lanes, warps and
    blocks sum which elements of a channel, so the summation order (the
    note at the top of ``csrc/fake_quant.cu``).  Runs (``inner > 1``):
    ``warps`` warps of a block take a channel, or with ``cluster > 1`` the 8
    warps of each of ``cluster`` blocks.  Rows (``inner == 1``): the 8 warps
    of each of ``cluster`` blocks walk the rows of a strip of channels."""
    if inner == 1:
        strips, cluster = -(-c // 32), 1
        while (cluster < _MAX_CLUSTER and strips * cluster < _FILL
               and outer >= 2 * cluster * _BLOCK_WARPS * _WARP_ROWS):
            cluster *= 2
        return _BLOCK_WARPS, cluster
    groups = -(-outer * inner // 4)
    warps, cluster = 1, 1
    while warps < _BLOCK_WARPS and groups >= 2 * warps * 32:
        warps *= 2
    while (warps == _BLOCK_WARPS and cluster < _MAX_CLUSTER and c * cluster < _FILL
           and groups >= 2 * cluster * _BLOCK_WARPS * 32 * _CLUSTER_GROUPS):
        cluster *= 2
    return warps, cluster


_pt_slots: dict = {}  # (device index, stream) -> the per-tensor backward's slot
_pt_slots_lock = threading.Lock()


def _pt_slot(lib, x: torch.Tensor, stream: int) -> int:
    """The slot (ticket counter and partials, ``csrc/fake_quant.cu``) of the
    per-tensor backward on ``stream``: one a stream of a device, so calls on
    two streams at once never share one; calls queued on one stream run in
    order.  A CUDA graph keeps the slot of the stream it was captured on.
    Raises past the library's ``lib.pt_slots`` streams a device."""
    key = (x.device.index, stream)
    with _pt_slots_lock:
        slot = _pt_slots.get(key)
        if slot is None:
            slot = sum(1 for k in _pt_slots if k[0] == key[0])
            if slot >= lib.pt_slots:
                raise RuntimeError(
                    f"per-tensor fake-quant backward: more than {lib.pt_slots} "
                    f"streams on {x.device}; each needs a slot of its own")
            _pt_slots[key] = slot
    return slot


def _range(spec: QuantSpec):
    return (float(spec.quant_min), float(spec.quant_max),
            float(spec.type_min), float(spec.type_max))


def _launch_forward(what: str, x: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor, spec: QuantSpec,
                    flags: Optional[torch.Tensor]) -> torch.Tensor:
    """One forward launch on the card: the static kernel, or with ``flags``
    its traced twin."""
    _check_cuda(what, x, scale, shift)
    outer, c, inner = _view3(x, spec)
    scale, shift = _qparams(scale, shift, c, what)
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    name = ("fq_fwd_pc" if spec.per_channel else "fq_fwd_pt") + (
        "" if flags is None else "_traced")
    ptrs = [x.data_ptr(), scale.data_ptr(), shift.data_ptr()]
    if flags is not None:
        ptrs.append(flags.data_ptr())
    dims = (outer, c, inner) if spec.per_channel else (x.numel(),)
    err = getattr(_build.load_library(), "jlt_" + name)(
        *ptrs, out.data_ptr(), *dims, *_range(spec),
        torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES[name] += 1
    _build.check(err, what)
    return out


def fake_quant_forward(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                       spec: QuantSpec, init_mode: bool = False) -> torch.Tensor:
    """Fake-quantized ``x``; ``init_mode`` returns ``x`` itself, no launch."""
    if init_mode:
        return x
    if _narrow(x, scale, shift):
        return fake_quant_forward(*_wide(x, scale, shift), spec).to(x.dtype)
    if x.device.type == "cpu":
        return golden_forward(x, scale, shift, spec)
    return _launch_forward("fake_quant_forward", x, scale, shift, spec, None)


def fake_quant_backward(grad: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, spec: QuantSpec,
                        eval_mode: bool = False, init_mode: bool = False,
                        numel: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dX, dS, dB)``: dX the STE gradient (``grad`` itself in init mode),
    dS/dB reduced to the qparams' shape (zeros in eval mode)."""
    if _narrow(grad, x, scale, shift):
        dx, ds, db = fake_quant_backward(*_wide(grad, x, scale, shift), spec,
                                         eval_mode, init_mode, numel)
        return dx.to(x.dtype), ds.to(scale.dtype), db.to(shift.dtype)
    if x.device.type == "cpu":
        return golden_backward(grad, x, scale, shift, spec, eval_mode=eval_mode,
                               init_mode=init_mode, numel=numel)
    grad, x, scale, shift, (outer, c, inner) = _checked_pair(
        "fake_quant_backward", grad, x, scale, shift, spec)
    if eval_mode or x.numel() == 0:
        ds, db = torch.zeros_like(scale), torch.zeros_like(shift)
        if init_mode or x.numel() == 0:
            return (grad if init_mode else torch.zeros_like(x)), ds, db
    else:
        ds, db = torch.empty_like(scale), torch.empty_like(shift)
    dx = grad if init_mode else torch.empty_like(x)
    lib = _build.load_library()
    n = numel if numel is not None else x.numel()
    gs = effective_grad_scale(spec, n, c)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (grad.data_ptr(), x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            dx.data_ptr())
    flags = (int(spec.symmetric), int(eval_mode), int(init_mode), gs, stream)
    if spec.per_channel:
        err = lib.jlt_fq_bwd_pc(*ptrs, ds.data_ptr(), db.data_ptr(), outer, c, inner,
                                *pc_plan(outer, c, inner), *_range(spec), *flags)
        LAUNCHES["fq_bwd_pc"] += 1
    else:
        err = lib.jlt_fq_bwd_pt(*ptrs, ds.data_ptr(), db.data_ptr(), x.numel(),
                                _pt_slot(lib, x, stream), *_range(spec), *flags)
        LAUNCHES["fq_bwd_pt"] += 1
    _build.check(err, "fake_quant_backward")
    return dx, ds, db


def _flags(flags: torch.Tensor, x: torch.Tensor, what: str) -> torch.Tensor:
    if flags.shape != (2,) or flags.dtype != torch.float32 or flags.device != x.device:
        raise ValueError(f"{what}: flags must be a (2,) float32 tensor [eval, init] "
                         f"on {x.device}, got {tuple(flags.shape)} {flags.dtype} "
                         f"on {flags.device}")
    return flags.contiguous()


def fake_quant_forward_traced(x: torch.Tensor, scale: torch.Tensor,
                              shift: torch.Tensor, flags: torch.Tensor,
                              spec: QuantSpec) -> torch.Tensor:
    """``init ? x : fake_quant(x)`` with ``flags = [eval, init]`` on the
    device; a new tensor in every mode (one launch)."""
    if _narrow(x, scale, shift):
        return fake_quant_forward_traced(*_wide(x, scale, shift), flags,
                                         spec).to(x.dtype)
    if x.device.type == "cpu":
        return golden_forward_traced(x, scale, shift, spec, flags[0], flags[1])
    what = "fake_quant_forward_traced"
    return _launch_forward(what, x, scale, shift, spec, _flags(flags, x, what))


def fake_quant_backward_traced(grad: torch.Tensor, x: torch.Tensor,
                               scale: torch.Tensor, shift: torch.Tensor,
                               flags: torch.Tensor, spec: QuantSpec,
                               numel: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dX, dS, dB)`` with ``flags = [eval, init]`` on the device: dX is
    ``grad`` in init mode and the STE gradient otherwise; dS/dB are scaled
    by ``gs·(1 − eval)``.  Every output is a new tensor, in every mode."""
    if _narrow(grad, x, scale, shift):
        dx, ds, db = fake_quant_backward_traced(*_wide(grad, x, scale, shift),
                                                flags, spec, numel)
        return dx.to(x.dtype), ds.to(scale.dtype), db.to(shift.dtype)
    if x.device.type == "cpu":
        return golden_backward_traced(grad, x, scale, shift, spec, flags[0],
                                      flags[1], numel=numel)
    grad, x, scale, shift, (outer, c, inner) = _checked_pair(
        "fake_quant_backward_traced", grad, x, scale, shift, spec)
    flags = _flags(flags, x, "fake_quant_backward_traced")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx, torch.zeros_like(scale), torch.zeros_like(shift)
    ds, db = torch.empty_like(scale), torch.empty_like(shift)
    lib = _build.load_library()
    n = numel if numel is not None else x.numel()
    gs = effective_grad_scale(spec, n, c)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (grad.data_ptr(), x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            flags.data_ptr(), dx.data_ptr())
    if spec.per_channel:
        err = lib.jlt_fq_bwd_pc_traced(*ptrs, ds.data_ptr(), db.data_ptr(), outer, c,
                                       inner, *pc_plan(outer, c, inner), *_range(spec),
                                       int(spec.symmetric), gs, stream)
        LAUNCHES["fq_bwd_pc_traced"] += 1
    else:
        err = lib.jlt_fq_bwd_pt_traced(*ptrs, ds.data_ptr(), db.data_ptr(), x.numel(),
                                       _pt_slot(lib, x, stream), *_range(spec),
                                       int(spec.symmetric), gs, stream)
        LAUNCHES["fq_bwd_pt_traced"] += 1
    _build.check(err, "fake_quant_backward_traced")
    return dx, ds, db


def fake_quant_fwdbwd(grad: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, *, spec: QuantSpec,
                      numel: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """``(out, dX, dS, dB)``: the train-mode forward and backward in one
    pass (one launch), equal to ``fake_quant_forward`` and
    ``fake_quant_backward`` on the same inputs: out and dX bit for bit, and
    on the card dS/dB too (the same grid and summation order)."""
    if _narrow(grad, x, scale, shift):
        out, dx, ds, db = fake_quant_fwdbwd(*_wide(grad, x, scale, shift),
                                            spec=spec, numel=numel)
        return (out.to(x.dtype), dx.to(x.dtype), ds.to(scale.dtype),
                db.to(shift.dtype))
    if x.device.type == "cpu":
        return (golden_forward(x, scale, shift, spec),
                *golden_backward(grad, x, scale, shift, spec, numel=numel))
    grad, x, scale, shift, (outer, c, inner) = _checked_pair(
        "fake_quant_fwdbwd", grad, x, scale, shift, spec)
    out, dx = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return out, dx, torch.zeros_like(scale), torch.zeros_like(shift)
    ds, db = torch.empty_like(scale), torch.empty_like(shift)
    lib = _build.load_library()
    gs = effective_grad_scale(spec, numel if numel is not None else x.numel(), c)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (grad.data_ptr(), x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), dx.data_ptr())
    if spec.per_channel:
        err = lib.jlt_fq_fwdbwd_pc(*ptrs, ds.data_ptr(), db.data_ptr(), outer, c, inner,
                                   *pc_plan(outer, c, inner), *_range(spec),
                                   int(spec.symmetric), gs, stream)
        LAUNCHES["fq_fwdbwd_pc"] += 1
    else:
        err = lib.jlt_fq_fwdbwd_pt(*ptrs, ds.data_ptr(), db.data_ptr(), x.numel(),
                                   _pt_slot(lib, x, stream), *_range(spec),
                                   int(spec.symmetric), gs, stream)
        LAUNCHES["fq_fwdbwd_pt"] += 1
    _build.check(err, "fake_quant_fwdbwd")
    return out, dx, ds, db
