"""The expensive observers' device work: the MSE observer's candidate search,
the histogram observer's update and its range search (no TPU kernel of their
own: jaxlsq runs them as XLA programs behind a ``lax.cond``).

* On a CPU tensor each function runs its plain version, PyTorch ops that
  follow the JAX package's formulas operation by operation.
* On a CUDA tensor it launches ``csrc/observers.cu`` (``mse_range``,
  ``hist_update``, ``hist_search``) or raises; there is no path from a CUDA
  tensor to the plain version.
* ``gate`` (a () bool tensor, the quantizer's ``observer_enabled``) makes a
  kernel return at once and write nothing when it is false: the traced
  regime's counterpart of jaxlsq's ``lax.cond``.  ``None`` always runs.  On
  the CPU the wrapper reads it on the host and, when false, runs nothing
  either; the caller where-merges the (unwritten) result away.
* Every kernel sums in an order fixed by the shape alone and uses no float
  atomics, so a rerun gives the same bits.  ``LAUNCHES`` counts the kernel
  launches of each kind.

Each function's inputs and outputs are f32.  ``out`` (and ``errs``,
``best``, ``iters``) may be given to be written in place; otherwise new
tensors are returned.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..core.spec import QuantSpec

__all__ = ["LAUNCHES", "MSE_CANDIDATES", "linspace", "mse_plan", "mse_range",
           "mse_range_plain", "hist_update", "hist_update_plain", "hist_search",
           "hist_search_plain", "quant_error_plain"]

LAUNCHES = {"mse_range": 0, "hist_update": 0, "hist_search": 0}

MSE_CANDIDATES = 64  # the kernel's candidate count (MSEObserver's default)
_MAX_NUMEL = 2 ** 31 - 1
# mse_range's plan: a channel's chunks take at least _MSE_GROUPS groups of 4
# elements a thread (256 threads) and are at most _MSE_BLOCKS / C of them
_MSE_THREADS, _MSE_GROUPS, _MSE_BLOCKS = 256, 8, 1024
# hist_update: a block takes at least _HIST_ELEMENTS elements, in at most
# _HIST_BLOCKS blocks (132 blocks took 374 us at mobilenetv2's largest
# activation on the H100, 512 blocks 255 us)
_HIST_ELEMENTS, _HIST_BLOCKS = 8192, 512
_F32_MAX_COUNT = float(2 ** 24)  # a scatter-add of f32 ones stops here


def linspace(start, stop, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in f32, its formula: ``start * (1 -
    i / div) + stop * (i / div)`` for i < div = num - 1, then ``stop``.
    ``start``/``stop`` are floats or 0-d f32 tensors."""
    device = stop.device if torch.is_tensor(stop) else None
    start = torch.as_tensor(start, dtype=torch.float32, device=device)
    stop = torch.as_tensor(stop, dtype=torch.float32, device=device)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / float(div)
    out = start * (1.0 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def _check_cuda(what: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise NotImplementedError(f"{what}: the CUDA kernels take float32, got {t.dtype}")
    if ts[0].numel() > _MAX_NUMEL:
        raise ValueError(f"{what}: {ts[0].numel()} elements exceed the kernels' "
                         "32-bit indexing")


def _gate(gate: Optional[torch.Tensor], like: torch.Tensor, what: str):
    if gate is None:
        return None
    if gate.dtype != torch.bool or gate.numel() != 1 or gate.device != like.device:
        raise ValueError(f"{what}: gate must be a one-element bool tensor on "
                         f"{like.device}, got {gate.dtype} {tuple(gate.shape)} on "
                         f"{gate.device}")
    return gate.data_ptr()


def _off(gate: Optional[torch.Tensor]) -> bool:
    """A CPU call's gate, read on the host: whether it is off."""
    return gate is not None and not bool(gate)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _out(out: Optional[torch.Tensor], shape, like: torch.Tensor, dtype=torch.float32):
    if out is None:
        return torch.empty(shape, dtype=dtype, device=like.device)
    if tuple(out.shape) != tuple(shape) or out.dtype != dtype or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {dtype} tensor of shape {tuple(shape)}")
    return out


# ------------------------------------------------------------- mse_range

def _view3(x: torch.Tensor, per_channel: bool, axis: int):
    if not per_channel:
        return 1, 1, x.numel()
    axis = axis % x.dim()
    return math.prod(x.shape[:axis]), x.shape[axis], math.prod(x.shape[axis + 1:])


def mse_plan(c: int, n: int) -> Tuple[int, int]:
    """``(bpc, chunk)`` of ``mse_range`` for ``c`` channels of ``n``
    elements: each channel's elements in ``bpc`` chunks of ``chunk`` (a
    multiple of 1,024), a block each; it fixes the summation order."""
    per = 4 * _MSE_THREADS
    bpc = max(1, min(-(-n // (per * _MSE_GROUPS)), -(-_MSE_BLOCKS // c)))
    chunk = -(-(-(-n // bpc)) // per) * per
    return -(-n // chunk), chunk


def _candidate_qparams(bmin, bmax, spec: QuantSpec, num: int):
    """The (num, C) scales and zero points of the candidate ranges
    ``(bmin f_k, bmax f_k)``."""
    from ..observers.minmax import observer_qparams

    f = linspace(1.0 / num, 1.0, num).to(bmin.device)[:, None]
    return f, observer_qparams(bmin[None, :] * f, bmax[None, :] * f, spec)


def mse_range_plain(x: torch.Tensor, bmin: torch.Tensor, bmax: torch.Tensor,
                    spec: QuantSpec, per_channel: bool = False, axis: int = 1,
                    num_candidates: int = MSE_CANDIDATES):
    """``(new_min, new_max, errs, best)``: jaxlsq's ``MSEObserver._best_range``
    on the batch range ``bmin``/``bmax`` ((C,) each): for each candidate f_k
    of ``linspace(1/num, 1, num)`` the squared error of fake-quantizing x at
    the qparams of ``(bmin f_k, bmax f_k)``, summed over all but the channel
    axis (``errs``, (C, num)); the first least (``best``, (C,)) and ``(bmin,
    bmax) * f_best``."""
    xf = x.detach().to(torch.float32)
    outer, c, inner = _view3(xf, per_channel, axis)
    x3 = xf.reshape(outer, c, inner)
    f, (scale, zp) = _candidate_qparams(bmin, bmax, spec, num_candidates)
    qmin, qmax = float(spec.quant_min), float(spec.quant_max)
    errs = []
    for k in range(num_candidates):
        s = scale[k].reshape(1, c, 1)
        z = zp[k].reshape(1, c, 1)
        xq = torch.round(torch.clamp(x3 / s + z, qmin, qmax))
        errs.append((((xq - z) * s - x3) ** 2).sum(dim=(0, 2)))
    errs = torch.stack(errs, dim=1)  # (C, num)
    best = torch.argmin(errs, dim=1)
    fb = f[best, 0]
    return bmin * fb, bmax * fb, errs, best


def mse_range(x: torch.Tensor, bmin: torch.Tensor, bmax: torch.Tensor,
              spec: QuantSpec, per_channel: bool = False, axis: int = 1,
              num_candidates: int = MSE_CANDIDATES, gate: Optional[torch.Tensor] = None,
              out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              errs: Optional[torch.Tensor] = None, best: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(new_min, new_max)`` of :func:`mse_range_plain`; on the card one
    launch of ``mse_range`` (which also writes ``errs`` (C, 64) f32 and
    ``best`` (C,) int32 where given)."""
    if x.device.type == "cpu":
        if _off(gate):
            c = _view3(x, per_channel, axis)[1]
            return out if out is not None else (x.new_empty(c), x.new_empty(c))
        nmin, nmax, e, b = mse_range_plain(x, bmin, bmax, spec, per_channel, axis,
                                           num_candidates)
        if out is not None:
            out[0].copy_(nmin)
            out[1].copy_(nmax)
            nmin, nmax = out
        if errs is not None:
            errs.copy_(e)
        if best is not None:
            best.copy_(b)
        return nmin, nmax
    what = "mse_range"
    x = x.detach().contiguous()
    _check_cuda(what, x, bmin, bmax)
    if num_candidates != MSE_CANDIDATES:
        raise NotImplementedError(f"{what}: the kernel takes {MSE_CANDIDATES} "
                                  f"candidates, got {num_candidates}")
    outer, c, inner = _view3(x, per_channel, axis)
    if bmin.numel() != c or bmax.numel() != c:
        raise ValueError(f"{what}: the batch range must have {c} elements")
    bmin, bmax = bmin.contiguous(), bmax.contiguous()
    nmin, nmax = (_out(None, (c,), x), _out(None, (c,), x)) if out is None else (
        _out(out[0], (c,), x), _out(out[1], (c,), x))
    n = outer * inner
    if n == 0:
        raise ValueError(f"{what}: an empty channel has no range")
    bpc, chunk = mse_plan(c, n)
    part = torch.empty(c * bpc * MSE_CANDIDATES, dtype=torch.float32, device=x.device)
    tickets = torch.zeros(c, dtype=torch.int32, device=x.device)
    if errs is not None:
        errs = _out(errs, (c, MSE_CANDIDATES), x)
    if best is not None:
        best = _out(best, (c,), x, torch.int32)
    sym = bool(spec.symmetric)
    zp_sym = 0.0
    if sym and not (spec.quant_min <= 0 <= spec.quant_max and spec.quant_min < 0):
        zp_sym = float((spec.quant_min + spec.quant_max + 1) // 2)
    err = _build.load_library().jlt_mse_range(
        x.data_ptr(), bmin.data_ptr(), bmax.data_ptr(), _gate(gate, x, what),
        part.data_ptr(), tickets.data_ptr(), nmin.data_ptr(), nmax.data_ptr(),
        None if errs is None else errs.data_ptr(),
        None if best is None else best.data_ptr(), c, inner, n, bpc, chunk,
        float(spec.quant_min), float(spec.quant_max), int(sym), zp_sym, _stream(x))
    LAUNCHES["mse_range"] += 1
    _build.check(err, what)
    return nmin, nmax


# ----------------------------------------------------------- hist_update

def _histc(x: torch.Tensor, bins: int, mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """jaxlsq's ``_histc`` (``torch.histc`` semantics) counted in integers:
    out-of-range values ignored, x == mx in the last bin, a degenerate range
    in bin ``bins // 2``; a count saturates at 2^24 as an f32 scatter-add of
    ones does."""
    x = x.reshape(-1)
    width = (mx - mn) / bins
    degenerate = width <= 0
    safe_w = torch.where(degenerate, torch.ones_like(width), width)
    idx = torch.floor((x - mn) / safe_w)
    idx = torch.where(x >= mx, torch.full_like(idx, bins - 1), idx)
    idx = torch.where(degenerate, torch.full_like(idx, bins // 2), idx)
    valid = (x >= mn) & (x <= mx)
    idx = torch.clamp(idx, 0, bins - 1).to(torch.int64)
    counts = torch.bincount(idx[valid], minlength=bins)
    return counts.clamp(max=int(_F32_MAX_COUNT)).to(torch.float32)


def hist_update_plain(x: torch.Tensor, hist: torch.Tensor, omin: torch.Tensor,
                      omax: torch.Tensor, nmin: torch.Tensor, nmax: torch.Tensor,
                      seen: torch.Tensor, upsample_rate: int = 16) -> torch.Tensor:
    """The new (bins,) histogram of jaxlsq's ``HistogramObserver.update``:
    the batch's histc over the new range ``[nmin, nmax]`` plus the old
    histogram (over ``[omin, omax]``) in the new grid (itself when the range
    did not move, all its mass at omin when it was degenerate, else
    ``_upscale``), or the batch's alone when ``seen`` is 0.  The ranges are
    (1,) tensors, ``seen`` () int32."""
    bins, u = hist.numel(), upsample_rate
    omin, omax, nmin, nmax = (t.reshape(()) for t in (omin, omax, nmin, nmax))
    update = _histc(x.detach().to(torch.float32), bins, nmin, nmax)
    same = (nmin == omin) & (nmax == omax)
    old_degenerate = omin == omax
    deg = _histc(omin.reshape(1), bins, nmin, nmax) * hist.sum()
    src_max = torch.where(old_degenerate, omin + 1.0, omax)
    fine = hist.repeat_interleave(u) / u
    bin_size = (src_max - omin) / (bins * u)
    mid = linspace(omin, src_max, bins * u + 1)[:-1] + 0.5 * bin_size
    boundaries = linspace(nmin, nmax, bins + 1)
    assign = (torch.searchsorted(boundaries, mid, right=True) - 1).clamp(0, bins - 1)
    remapped = torch.zeros_like(hist).index_add_(0, assign, fine)
    old_in_new = torch.where(same, hist, torch.where(old_degenerate, deg, remapped))
    return torch.where(seen == 0, update, update + old_in_new)


def _hist_blocks(n: int) -> int:
    return max(1, min(-(-n // _HIST_ELEMENTS), _HIST_BLOCKS))


def hist_update(x: torch.Tensor, hist: torch.Tensor, omin: torch.Tensor,
                omax: torch.Tensor, nmin: torch.Tensor, nmax: torch.Tensor,
                seen: torch.Tensor, upsample_rate: int = 16,
                gate: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`hist_update_plain`; on the card one launch of ``hist_update``."""
    if x.device.type == "cpu":
        if _off(gate):
            return out if out is not None else torch.empty_like(hist)
        new = hist_update_plain(x, hist, omin, omax, nmin, nmax, seen, upsample_rate)
        return new if out is None else out.copy_(new)
    what = "hist_update"
    x = x.detach().reshape(-1).contiguous()
    _check_cuda(what, x, hist, omin, omax, nmin, nmax)
    lib = _build.load_library()
    bins = hist.numel()
    if bins > lib.hist_max_bins:
        raise NotImplementedError(f"{what}: at most {lib.hist_max_bins} bins, got {bins}")
    if seen.dtype != torch.int32:
        raise ValueError(f"{what}: seen must be int32, got {seen.dtype}")
    out = _out(out, (bins,), x)
    work = torch.zeros(bins + 1, dtype=torch.int32, device=x.device)
    hist = hist.contiguous()
    err = lib.jlt_hist_update(
        x.data_ptr(), x.numel(), hist.data_ptr(), omin.data_ptr(), omax.data_ptr(),
        nmin.data_ptr(), nmax.data_ptr(), seen.data_ptr(), _gate(gate, x, what),
        work.data_ptr(), out.data_ptr(), bins, upsample_rate, _hist_blocks(x.numel()),
        _stream(x))
    LAUNCHES["hist_update"] += 1
    _build.check(err, what)
    return out


# ----------------------------------------------------------- hist_search

def _pairwise_sum(t: torch.Tensor) -> torch.Tensor:
    """The adjacent pairwise tree of ``t`` padded with +0 to a power of two
    (at least 2,048): pairs, then pairs of pairs, ...: ``hist_search``'s
    order."""
    n = max(2048, 1 << max(0, (t.numel() - 1).bit_length()))
    t = torch.cat([t, t.new_zeros(n - t.numel())])
    while t.numel() > 1:
        t = t[0::2] + t[1::2]
    return t[0]


def quant_error_plain(hist: torch.Tensor, bin_width: torch.Tensor, start: int, end: int,
                      dst_nbins: int) -> torch.Tensor:
    """jaxlsq's ``HistogramObserver._quant_error``: the L2 error of
    quantizing the piecewise-uniform histogram to ``dst_nbins`` levels over
    bins ``[start, end]``, each bin's term as jaxlsq's, summed by
    :func:`_pairwise_sum`."""
    bins = hist.numel()
    dst_w = bin_width * float(end - start + 1) / dst_nbins
    safe_dst = torch.where(dst_w == 0, torch.ones_like(dst_w), dst_w)
    src = torch.arange(bins, dtype=torch.float32, device=hist.device)
    begin = (src - float(start)) * bin_width
    end_ = begin + bin_width
    dst_of_begin = torch.clamp(torch.floor(begin / safe_dst), 0, dst_nbins - 1)
    dst_of_end = torch.clamp(torch.floor(end_ / safe_dst), 0, dst_nbins - 1)
    density = hist / torch.where(bin_width == 0, torch.ones_like(bin_width), bin_width)

    def norm(b, e):
        return density * (e * e * e - b * b * b) / 3.0

    begin_center = (dst_of_begin + 0.5) * safe_dst
    total = norm(begin - begin_center, (safe_dst / 2).expand(bins))
    total = total + (dst_of_end - dst_of_begin - 1) * norm(-safe_dst / 2, safe_dst / 2)
    end_center = dst_of_end * safe_dst + safe_dst / 2
    total = total + norm(-safe_dst / 2, end_ - end_center)
    return torch.where(dst_w == 0, torch.zeros_like(dst_w), _pairwise_sum(total))


def _step_sequences(n: int = 100_002):
    """alpha_i = alpha_(i-1) + 1e-5 from 0 and beta_i = beta_(i-1) - 1e-5 from
    1, each add rounded to f32, as the loop steps them (numpy accumulates an
    f32 cumsum in order)."""
    step = np.float32(1e-5)
    return tuple(np.cumsum(np.concatenate([[np.float32(v0)], np.full(n - 1, d, np.float32)]),
                           dtype=np.float32) for v0, d in ((0.0, step), (1.0, -step)))


def hist_search_plain(hist: torch.Tensor, min_val: torch.Tensor, max_val: torch.Tensor,
                      dst_nbins: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """``((2,) chosen (min, max), (trips, scored))``: jaxlsq's ``_search`` (torch's
    ``_non_linear_param_search``) on CPU tensors.  alpha/beta step by 1e-5
    in f32, the quantiles are searched on ``torch.cumsum`` of the histogram
    (on the CPU each prefix a double sum rounded to f32), and the error is
    :func:`quant_error_plain`, computed only when the range moved (jaxlsq
    computes and discards it otherwise; ``scored`` counts those trips).  An
    empty histogram never moves the range and takes no trip."""
    if hist.device.type != "cpu":
        raise ValueError("hist_search_plain runs on CPU tensors")
    bins = hist.numel()
    omin = min_val.reshape(())
    bin_width = (max_val.reshape(()) - omin) / bins
    csum = torch.cumsum(hist, 0).numpy()
    total = csum[-1]
    alpha, beta = _step_sequences()
    # each quantile's bin, for every alpha and beta the loop can reach
    lefts = np.searchsorted(csum, alpha * total, side="left").tolist()
    rights = (np.searchsorted(csum, beta * total, side="right") - 1).tolist()
    alpha_lt_beta = lambda i, j: alpha[i] < beta[j]  # noqa: E731
    ia = ib = 0
    norm_min = np.float32(np.inf)
    start, end, trips, scored = 0, bins - 1, 0, 0
    done = not total > 0
    while not done and alpha_lt_beta(ia, ib):
        trips += 1
        left = min(max(lefts[ia + 1], start), end)
        right = min(max(rights[ib + 1], start), end)
        move_start = (left - start) > (end - right)
        n_start, n_end = (left, end) if move_start else (start, right)
        if move_start:
            ia += 1
        else:
            ib += 1
        if n_start == start and n_end == end:
            continue
        scored += 1
        nrm = np.float32(quant_error_plain(hist, bin_width, n_start, n_end, dst_nbins))
        if nrm > norm_min:
            done = True
        else:
            start, end, norm_min = n_start, n_end, nrm
    lo = omin + bin_width * float(start)
    hi = omin + bin_width * (float(end) + 1.0)
    return torch.stack([lo, hi]), (trips, scored)


def hist_search(hist: torch.Tensor, min_val: torch.Tensor, max_val: torch.Tensor,
                dst_nbins: int, gate: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None,
                iters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (2,) chosen ``(min, max)`` of :func:`hist_search_plain`; on the
    card one launch of ``hist_search`` (which also writes the loop's trips
    and scored trips into ``iters``, (2,) int32, where given)."""
    if hist.device.type == "cpu":
        if _off(gate):
            return out if out is not None else hist.new_empty(2)
        new, counts = hist_search_plain(hist, min_val, max_val, dst_nbins)
        if iters is not None:
            iters.copy_(torch.tensor(counts, dtype=torch.int32))
        return new if out is None else out.copy_(new)
    what = "hist_search"
    _check_cuda(what, hist, min_val, max_val)
    lib = _build.load_library()
    bins = hist.numel()
    if bins > lib.hist_max_bins:
        raise NotImplementedError(f"{what}: at most {lib.hist_max_bins} bins, got {bins}")
    out = _out(out, (2,), hist)
    if iters is not None and (iters.dtype != torch.int32 or iters.numel() != 2):
        raise ValueError(f"{what}: iters must be a two-element int32 tensor")
    hist = hist.contiguous()
    err = lib.jlt_hist_search(
        hist.data_ptr(), min_val.data_ptr(), max_val.data_ptr(), _gate(gate, hist, what),
        out.data_ptr(), None if iters is None else iters.data_ptr(), bins, dst_nbins,
        _stream(hist))
    LAUNCHES["hist_search"] += 1
    _build.check(err, what)
    return out
