"""Weight-only int8/int4 matmul with the dequant fused in (port of
``jaxlsq/serve/matmul.py::wo_matmul``).

``wo_matmul(x, packed)`` computes ``x @ dequant(packed)`` for a logical
(K, N) weight with per-channel qparams on N (or (1,) per-tensor), or with
group-wise (G, N) scales (``packed.group_size``, int4).

While a program is traced (``torch.export``, ``torch.compile``) it calls
the ``jaxlsq_torch::wo_matmul`` operator (``serve.custom_ops``), whose
implementations are the two below; eager code calls them directly (the
operator's boxed call cost 13-15% of a B = 1 decode token, PERF.md):

* On a CPU tensor it runs the plain version :func:`wo_matmul_plain`
  (``x @ dequantize_weight(packed)`` in f32).
* On a CUDA tensor it launches ``csrc/wo_matmul.cu`` (``wo8`` for int8,
  ``wo4`` for split-half int4, ``wo4g`` for group-wise int4) for every M, or
  raises.  Each is one launch with no workspace (the wrapper allocates only
  ``out``) and sums in one order for every M.
  ``wo8`` and ``wo4`` run on the tensor cores (``csrc/mma_bf16.cuh``, bf16
  ``mma.sync``): x split exactly into three bf16 parts, the factor
  ``(w - z)`` an exact bf16 (zero points in the int8 carrier's range, as
  ``_fold_qparams`` clamps them), so every product is exact; the k values
  (int4: byte row r's low nibble k = r, its high nibble k = r + ceil(K/2))
  cut into slices of 64, each slice the tensor cores' chain from +0, the
  even slices left-folded in order into one f32 lane and the odd ones into
  another, ``out = (lane0 + lane1) * s``.
  ``wo4g`` runs f32 FMAs: 32-byte-row slices, each byte row's low nibble's
  term and then its high nibble's, an fmaf chain from +0 of exact f32
  factors ``w * s[k // gs]``, folded in slice order.  It takes group sizes
  and K / 2 that are multiples of 128 (the JAX package's TPU limits do not
  apply); another grouped pack raises ``ValueError``.

The int8 x int8 paths (the JAX package's ``static_int8_matmul``,
``dynamic_int8_matmul`` and ``static_int8_conv``) quantize the activation to
int8 (``act_quant_i8``) and run the integer product with the dequant epilogue
fused (``i8mm``), both in ``csrc/int8_matmul.cu`` on a CUDA tensor, and in
their plain versions (the ``*_plain`` functions: the same integers, the
epilogue's f32 operations in the same order) on a CPU tensor; while a
program is traced, through the ``jaxlsq_torch::act_quant_i8``,
``jaxlsq_torch::i8mm`` and ``jaxlsq_torch::i8mm_fused`` operators, which
pick by the device.  The integer product is exact, so the kernel's output is
the plain version's bit for bit.  :func:`i8mm_plan` (pure Python) picks the
kernel's row tile and its K split over a thread-block cluster from the shape
(a convolution's products take the kernel's conv form instead);
where it says ``fused`` (the matmul callers at decode M), ``i8mm`` quantizes
its A rows itself: a static layer is one launch, a dynamic one two (the
absmax partials, then the product).  The convolution takes NCHW activations
and the pack as ``QuantConv`` holds it (HWIO); it gathers the windows of the
int8 activation (im2col, padded with the integer zero point) with PyTorch ops
and runs one product per group.

``LAUNCHES`` counts the kernel launches of each kind (``act_quant_i8`` one a
call: its dynamic mode is two launches, the absmax's partials and the
quantizing pass; a fused dynamic call's absmax pass counts here too).
``i8mm`` counts every launch of the product; ``i8mm_fused`` those of them
that quantized their A rows themselves.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import _build
from .pack import PackedWeight, dequantize_weight, true_div

__all__ = ["wo_matmul", "wo_matmul_plain", "act_quant_i8", "act_quant_i8_plain",
           "int8_product_plain", "static_int8_matmul", "static_int8_matmul_plain",
           "dynamic_int8_matmul", "dynamic_int8_matmul_plain", "static_int8_conv",
           "static_int8_conv_plain", "static_int8_bmm", "static_int8_bmm_plain",
           "same_padding", "conv_pads", "conv_operands", "i8mm_plan", "I8mmPlan",
           "LAUNCHES"]

LAUNCHES = {"wo8": 0, "wo4": 0, "wo4g": 0, "act_quant_i8": 0, "i8mm": 0, "i8mm_fused": 0}


def wo_matmul_plain(x: torch.Tensor, packed: PackedWeight) -> torch.Tensor:
    """``x @ dequant(W)`` in f32: the reference for the kernels."""
    w = dequantize_weight(packed, torch.float32)
    return torch.matmul(x.to(torch.float32), w)


def _launch(x2d: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
            zero_point: torch.Tensor, bits: int, kdim: int, n: int,
            gs: int) -> torch.Tensor:
    """The ``wo*`` kernel for a (K, N) pack's fields (``gs`` 0: not grouped)."""
    m = x2d.shape[0]
    dev = x2d.device
    for name, t in (("data", data), ("scale", scale), ("zero_point", zero_point)):
        if t.device != dev:
            raise ValueError(f"wo_matmul: packed.{name} is on {t.device}, x on {dev}")
    data = data.contiguous()
    if data.dtype != torch.int8 or data.data_ptr() % 4:
        raise ValueError("wo_matmul: packed data must be 4-byte aligned int8")
    rows = kdim if bits == 8 else (kdim + 1) // 2
    if tuple(data.shape) != (rows, n):
        raise ValueError(f"wo_matmul: packed data shape {tuple(data.shape)} "
                         f"!= {(rows, n)} for bits={bits}, K={kdim}")
    scale = scale.to(torch.float32).contiguous()
    zp = zero_point.to(torch.int32).contiguous()
    lib = _build.load_library()
    if gs:
        align = lib.group_rows
        if bits != 4 or kdim % 2 or gs % align or (kdim // 2) % align:
            raise ValueError(
                f"wo_matmul: the wo4g kernel takes int4 packs whose group size "
                f"and K / 2 are multiples of {align} (got bits={bits}, "
                f"group_size={gs}, K={kdim})")
        if tuple(scale.shape) != (kdim // gs, n):
            raise ValueError(f"wo_matmul: group scales {tuple(scale.shape)} "
                             f"!= {(kdim // gs, n)}")
    elif scale.numel() not in (1, n) or zp.numel() != scale.numel():
        raise ValueError("wo_matmul: qparams must be (N,) or (1,)")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    per_channel = int(scale.numel() == n and n > 1)
    args = (x2d.data_ptr(), data.data_ptr(), scale.data_ptr(), zp.data_ptr(),
            out.data_ptr(), m, kdim, n, per_channel)
    if bits == 8:
        err = lib.jlt_wo8(*args, stream)
        name = "wo8"
    else:
        err = lib.jlt_wo4(*args, gs, stream)
        name = "wo4g" if gs else "wo4"
    LAUNCHES[name] += 1
    _build.check(err, "wo_matmul")
    return out


def _wo_launch(x: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
               zero_point: torch.Tensor, bits: int, kdim: int, n: int,
               gs: int) -> torch.Tensor:
    """x (..., K) through the ``wo*`` kernel: (..., N) f32."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, kdim).contiguous()
    if x2d.shape[0] == 0:
        return x.new_zeros(*lead, n)
    return _launch(x2d, data, scale, zero_point, bits, kdim, n, gs).reshape(*lead, n)


def wo_matmul(x: torch.Tensor, packed: PackedWeight) -> torch.Tensor:
    """``x @ dequant(packed)`` for x (..., K); returns (..., N) f32."""
    if len(packed.orig_shape) != 2:
        raise ValueError("wo_matmul needs a 2-D (K, N) packed weight")
    kdim, n = packed.orig_shape
    if x.shape[-1] != kdim:
        raise ValueError(f"wo_matmul: x has K={x.shape[-1]}, weight K={kdim}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wo_matmul: unsupported device {x.device}")
    if x.device.type == "cuda" and x.dtype != torch.float32:
        raise ValueError(f"wo_matmul: the kernel takes f32 activations, got {x.dtype}")
    gs = packed.group_size or 0
    if torch.compiler.is_compiling():
        return torch.ops.jaxlsq_torch.wo_matmul(x, packed.data, packed.scale,
                                                packed.zero_point, packed.bits, packed.axis,
                                                packed.k_axis, kdim, n, gs)
    if x.device.type == "cpu":
        return wo_matmul_plain(x, packed)
    return _wo_launch(x, packed.data, packed.scale, packed.zero_point, packed.bits, kdim, n,
                      gs)


# --------------------------------------------------------------------------
# int8 x int8 (act_quant_i8 and i8mm)
# --------------------------------------------------------------------------

_EPILOGUES = {"static": 0, "dynamic": 1, "conv": 2}
_MAX_K = 131072  # K * 128 * 128 < 2^31: the int32 sums stay exact
_WORK = 1024     # the dynamic absmax's partials (csrc kMaxPartials)
# i8mm's tiling (csrc/int8_matmul.cu): 128 or 64 output columns a block, k
# in stages of 128 rows, clusters of at most 8 blocks (the portable size)
I8MM_BK, I8MM_MAX_CLUSTER = 128, 8
I8MM_ROWS = (16, 32, 64, 128)   # a block's row tile (1 x 4, 2 x 4, 4 x 2, 8 x 1 warps)
I8MM_COLS = (128, 64)           # a block's column tile (64 up to 64 rows)
FUSED_MAX_M = 1                 # the fused quantization up to this M (card runs)
_RESIDENT_MAX = 32 * 1024       # a fused block's quantized A rows in shared memory
_WAVE = 0.9                     # of the SMs: the blocks that count as a wave
_PREFILL_WAVE = 0.7             # above 32 rows (card runs)


@dataclasses.dataclass(frozen=True)
class I8mmPlan:
    """One ``i8mm`` launch: ``bm`` x ``bn`` output tiles; K over clusters of
    ``cs`` blocks, rank r owning k in ``[r * kper, (r + 1) * kper)``;
    ``fused``: the kernel quantizes its A rows itself."""
    bm: int
    bn: int
    cs: int
    kper: int
    fused: bool

    def grid(self, m: int, n: int, batch: int = 1):
        return (-(-n // self.bn) * self.cs, -(-m // self.bm), batch)


def i8mm_plan(m: int, n: int, k: int, batch: int = 1, *, fused: bool = False,
              sms: int = 132, bm: int = None, bn: int = None, cs: int = None) -> I8mmPlan:
    """The tile and K split of an (m, k) x (k, n) product, ``batch`` times,
    on a card of ``sms`` SMs (the rule from card runs over the d1024 LM's
    shapes at M = 1, 16 and 256).  The row tile is the smallest of 16, 32,
    64 that holds m; above 64 rows, 128 where those tiles alone give the
    card a wave, else 64.  Up to 32 rows (decode) the column tile is 64 and
    the target a wave of blocks (0.9 of the SMs); above (prefill) the
    column tile is 128 where 128-column tiles reach the target, else 64, and
    the target 0.7 of the SMs (a cluster's fold costs more than a few idle
    SMs save there).  The
    cluster is the smallest power of two (at most 8, and no more ranks than
    128-row stages) whose blocks reach the target and, fused, whose ranks'
    quantized rows fit in shared memory (32 KB); each rank then owns
    ``kper`` rows of K, a multiple of 128, and the cluster is cut to the
    ranks that own some.  ``fused`` holds where it was asked, m <=
    FUSED_MAX_M and the block's quantized rows fit.
    ``bm``, ``bn`` and ``cs`` force a tile and a cluster (the card checks
    run every size the rule can pick)."""
    if min(m, n, k, batch) <= 0:
        raise ValueError(f"i8mm_plan: empty product ({m}, {n}, {k}, {batch})")
    wave = _WAVE * sms
    steps = -(-k // I8MM_BK)
    if bm is None:
        bm = next((r for r in I8MM_ROWS[:3] if m <= r), None)
        if bm is None:
            bm = 128 if -(-n // 128) * -(-m // 128) * batch >= wave else 64
    if bm not in I8MM_ROWS:
        raise ValueError(f"i8mm_plan: no {bm}-row tile")
    rows = -(-m // bm) * batch
    target = wave if bm <= 32 else _PREFILL_WAVE * sms
    if bn is None:
        bn = 64 if bm <= 32 or (bm == 64 and -(-n // 128) * rows < target) else 128
    if bn not in I8MM_COLS or (bn == 64 and bm > 64):
        raise ValueError(f"i8mm_plan: no {bm} x {bn} tile")
    tiles = -(-n // bn) * rows
    fused = bool(fused and m <= FUSED_MAX_M and bm <= 64)
    if cs is None:
        cs, most = 1, min(I8MM_MAX_CLUSTER, steps)
        while 2 * cs <= most and (tiles * cs < target or (
                fused and bm * -(-steps // cs) * I8MM_BK > _RESIDENT_MAX)):
            cs *= 2
    if not 1 <= cs <= min(I8MM_MAX_CLUSTER, steps):
        raise ValueError(f"i8mm_plan: cluster {cs} for {steps} stages")
    per = -(-steps // cs)
    cs = -(-steps // per)
    kper = per * I8MM_BK
    return I8mmPlan(bm, bn, cs, kper, fused and bm * kper <= _RESIDENT_MAX)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(dev: torch.device) -> int:
    """The device's SMs (the plan's wave); 132 (an H100's) off the card."""
    return _sm_count(dev.index if dev.index is not None else torch.cuda.current_device()) \
        if dev.type == "cuda" else 132


def _check_device(x: torch.Tensor, what: str) -> None:
    """A CPU tensor takes the plain versions, a CUDA one (f32) the kernels."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.device.type == "cuda" and x.dtype != torch.float32:
        raise ValueError(f"{what}: the kernels take f32 activations, got {x.dtype}")


def _to_int8(r: torch.Tensor) -> torch.Tensor:
    """The JAX package's float -> int8 conversion: saturating, NaN -> 0."""
    return torch.where(torch.isnan(r), torch.zeros_like(r),
                       r.clamp(-128.0, 127.0)).to(torch.int8)


def _act_shift(act_qmax: int) -> float:
    # an unsigned range overflows the int8 carrier: recentre by 128, which
    # leaves (x_q - zpx) * sx unchanged
    return 128.0 if act_qmax > 127 else 0.0


def act_quant_i8_plain(x: torch.Tensor, act_scale=None, act_zp=None, act_qmin: int = -128,
                       act_qmax: int = 127, *, dynamic: bool = False):
    """x -> (int8 x_q of x's shape, f32 (2,) [sx, zpx_c]).  Static:
    ``x_q = clip(round(x / sx + zpx), qmin, qmax) - shift`` with the frozen
    per-tensor qparams, ``zpx_c = zpx - shift``; dynamic: ``sx = max(max|x| /
    127, tiny)``, ``x_q = round(x / sx)``, ``zpx_c = 0``."""
    xf = x.to(torch.float32)
    if dynamic:
        sx = true_div(xf.abs().amax(), 127.0)
        sx = torch.maximum(sx, torch.full_like(sx, torch.finfo(torch.float32).tiny))
        return _to_int8(torch.round(xf / sx)), torch.stack([sx, torch.zeros_like(sx)])
    shift = _act_shift(act_qmax)
    sx = act_scale.to(torch.float32)[0]
    zpx = act_zp.to(torch.float32)[0]
    r = torch.clamp(torch.round(xf / sx + zpx), act_qmin, act_qmax) - shift
    return _to_int8(r), torch.stack([sx, zpx - shift])


def act_quant_i8(x: torch.Tensor, act_scale=None, act_zp=None, act_qmin: int = -128,
                 act_qmax: int = 127, *, dynamic: bool = False):
    """:func:`act_quant_i8_plain` on a CPU tensor; the ``act_quant_i8``
    kernel on a CUDA one (sx stays on the card)."""
    _check_device(x, "act_quant_i8")
    if torch.compiler.is_compiling():
        return torch.ops.jaxlsq_torch.act_quant_i8(x, act_scale, act_zp, int(act_qmin),
                                                   int(act_qmax), bool(dynamic))
    if x.is_cuda:
        return _act_quant_i8_launch(x, act_scale, act_zp, act_qmin, act_qmax, dynamic)
    return act_quant_i8_plain(x, act_scale, act_zp, act_qmin, act_qmax, dynamic=dynamic)


def _act_quant_i8_launch(x, act_scale, act_zp, act_qmin, act_qmax, dynamic):
    """The ``act_quant_i8`` kernel (the CUDA operator's implementation)."""
    if x.numel() == 0:
        raise ValueError("act_quant_i8: empty input")
    dev = x.device
    xc = x.contiguous()
    xq = torch.empty(x.shape, dtype=torch.int8, device=dev)
    qx = torch.empty(2, dtype=torch.float32, device=dev)
    if dynamic:
        scale = zp = qx  # not read
        work = torch.empty(_WORK, dtype=torch.int32, device=dev)
    else:
        scale = act_scale.to(device=dev, dtype=torch.float32).contiguous()
        zp = act_zp.to(device=dev, dtype=torch.int32).contiguous()
        work = qx  # not read
    lib = _build.load_library()
    err = lib.jlt_act_quant_i8(xc.data_ptr(), scale.data_ptr(), zp.data_ptr(), xq.data_ptr(),
                               qx.data_ptr(), work.data_ptr(), xc.numel(), float(act_qmin),
                               float(act_qmax), _act_shift(act_qmax), int(dynamic),
                               torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["act_quant_i8"] += 1
    _build.check(err, "act_quant_i8")
    return xq, qx


def int8_product_plain(a: torch.Tensor, b: torch.Tensor):
    """Batched ``a @ b`` of int8 (Bt, M, K) and (Bt, K, N) in exact integers
    (an f64 product: every partial sum is an integer below 2^53), with
    ``rowsum(a)`` (Bt, M) and ``colsum(b)`` (Bt, N), all int32."""
    acc = torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)
    return (acc, a.to(torch.int32).sum(-1, dtype=torch.int32),
            b.to(torch.int32).sum(-2, dtype=torch.int32))


def _weight_qparams(t: torch.Tensor, batch: int, n: int, qstrides) -> torch.Tensor:
    """The (Bt, 1, N) f32 view of a weight's scale or zero point indexed at
    ``b * qstrides[0] + n * qstrides[1]`` (the kernel's rule)."""
    dev = t.device
    idx = (torch.arange(batch, device=dev)[:, None] * qstrides[0]
           + torch.arange(n, device=dev)[None, :] * qstrides[1])
    return t.to(torch.float32).reshape(-1)[idx][:, None, :]


def _epilogue_plain(acc, rs, cs, qx, sw, zw, mode, kdim, window):
    """The dequant epilogue in the JAX package's order of f32 operations."""
    a = acc.to(torch.float32)
    rsf = rs.to(torch.float32)[..., None]
    csf = cs.to(torch.float32)[:, None, :]
    sx, zpx = qx[0], qx[1]
    if mode == "dynamic":
        o = a - rsf * zw
    elif mode == "static":
        o = a - zpx * csf
        o = o - zw * rsf
        o = o + (float(kdim) * zpx) * zw
    else:
        o = a - zpx * csf
        o = torch.where(zw != 0, o - zw * (rsf - zpx * window), o)
    return o * (sx * sw)


def _i8mm(a, b, qx, scale, zp, mode, qstrides, *, plain, window=0.0, conv_out=None,
          plan=None):
    """The epilogue-fused product of int8 a (Bt, M, K) and b (Bt, K, N)
    (views, unit stride along K and N): (Bt, M, N) f32, or with ``conv_out``
    = (images, H', W') the NCHW (images, Bt * N, H', W') of a grouped conv
    whose rows are (image, pixel), which takes the kernel's conv form (its
    first form: one 64 x 64 tile a block over the whole K, faster on a
    conv's few k and many rows in card runs).  ``plan``: a matmul's unfused
    :class:`I8mmPlan` (default :func:`i8mm_plan`'s)."""
    batch, m, kdim = a.shape
    n = b.shape[2]
    if plain:
        acc, rs, cs = int8_product_plain(a, b)
        out = _epilogue_plain(acc, rs, cs, qx, _weight_qparams(scale, batch, n, qstrides),
                              _weight_qparams(zp, batch, n, qstrides), mode, kdim, window)
        if conv_out is None:
            return out
        imgs, ho, wo = conv_out
        return out.reshape(batch, imgs, ho * wo, n).permute(1, 0, 3, 2).reshape(
            imgs, batch * n, ho, wo)
    if a.dtype != torch.int8 or a.stride(2) != 1:
        raise ValueError("i8mm: operands must be int8 with unit stride along K and N")
    vec_a = int(a.data_ptr() % 16 == 0 and a.stride(1) % 16 == 0 and a.stride(0) % 16 == 0)
    if conv_out is not None:
        if plan is not None:
            raise ValueError("i8mm: a conv takes the conv form, not a plan")
        return _i8mm_launch(a, b, qx, scale, zp, mode, qstrides, window, conv_out, None,
                            vec_a, None)
    plan = plan or i8mm_plan(m, n, kdim, batch, sms=_sms(a.device))
    if plan.fused:
        raise ValueError("i8mm: a fused plan takes f32 rows (_i8mm_fused)")
    return _i8mm_launch(a, b, qx, scale, zp, mode, qstrides, window, conv_out, plan, vec_a,
                        None)


def _i8mm_launch(a, b, qx, scale, zp, mode, qstrides, window, conv_out, plan, vec_a, quant):
    """One ``jlt_i8mm`` call, or with no ``plan`` one of the conv form
    (``jlt_i8mm_tile64``); ``quant`` (fused): (act_scale, act_zp, qmin,
    qmax, shift, dynamic) and ``a`` the f32 rows."""
    batch, m, kdim = a.shape
    n = b.shape[2]
    if kdim > _MAX_K:
        raise ValueError(f"i8mm: K = {kdim} exceeds {_MAX_K} (int32 sums)")
    dev = a.device
    for name, t in (("weight", b), ("scale", scale), ("zero_point", zp), ("qx", qx)):
        if t.device != dev:
            raise ValueError(f"i8mm: {name} is on {t.device}, x on {dev}")
    if b.dtype != torch.int8 or b.stride(2) != 1:
        raise ValueError("i8mm: operands must be int8 with unit stride along K and N")
    scale = scale.to(torch.float32).contiguous()
    zp = zp.to(torch.int32).contiguous()
    if conv_out is None:
        out = torch.empty((batch, m, n), dtype=torch.float32, device=dev)
        geom = (m * n, m, 0, n, 1)
    else:
        imgs, ho, wo = conv_out
        hw = ho * wo
        out = torch.empty((imgs, batch * n, ho, wo), dtype=torch.float32, device=dev)
        geom = (n * hw, hw, batch * n * hw, 1, hw)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), a.stride(0), b.stride(0), *geom,
            a.stride(1), b.stride(1), batch, m, n, kdim, qx.data_ptr(), scale.data_ptr(),
            zp.data_ptr(), qstrides[0], qstrides[1], _EPILOGUES[mode], float(window), vec_a)
    if plan is None:
        vec_b4 = int(b.data_ptr() % 4 == 0 and b.stride(1) % 4 == 0 and b.stride(0) % 4 == 0)
        err = lib.jlt_i8mm_tile64(*args, vec_b4, stream)
        LAUNCHES["i8mm"] += 1
        _build.check(err, "i8mm")
        return out
    vec_b = int(b.data_ptr() % 16 == 0 and b.stride(1) % 16 == 0 and b.stride(0) % 16 == 0)
    if quant is None:
        xs = xz = work = qx
        qmin = qmax = shift = 0.0
        dynamic = 0
    else:
        xs, xz, qmin, qmax, shift, dynamic = quant
        work = torch.empty(_WORK, dtype=torch.int32, device=dev) if dynamic else qx
    err = lib.jlt_i8mm(*args, vec_b, plan.bm, plan.bn, plan.cs, plan.kper,
                       int(quant is not None), xs.data_ptr(), xz.data_ptr(), work.data_ptr(),
                       float(qmin), float(qmax), float(shift), int(dynamic), stream)
    if quant is not None:
        LAUNCHES["i8mm_fused"] += 1
        if dynamic:
            LAUNCHES["act_quant_i8"] += 1
    LAUNCHES["i8mm"] += 1
    _build.check(err, "i8mm")
    return out


def _i8mm_fused(x, b, scale, zp, act_scale, act_zp, act_qmin, act_qmax, dynamic, qstrides,
                *, plain, plan=None):
    """:func:`act_quant_i8` of x (Bt, M, K) f32 then :func:`_i8mm` with the
    static (or dynamic) epilogue, as one fused ``i8mm`` launch (two for a
    dynamic call: the absmax partials first): returns (out, qx).  ``plain``:
    the two plain versions, which are this path's plain version."""
    mode = "dynamic" if dynamic else "static"
    if plain:
        xq, qx = act_quant_i8_plain(x, act_scale, act_zp, act_qmin, act_qmax, dynamic=dynamic)
        return _i8mm(xq, b, qx, scale, zp, mode, qstrides, plain=True), qx
    batch, m, kdim = x.shape
    plan = plan or i8mm_plan(m, b.shape[2], kdim, batch, fused=True, sms=_sms(x.device))
    if not plan.fused:
        raise ValueError(f"i8mm: the plan {plan} does not fuse the quantization")
    if x.dtype != torch.float32:
        raise ValueError(f"i8mm: the fused quantization takes f32 rows, got {x.dtype}")
    dev = x.device
    xc = x.contiguous()
    qx = torch.empty(2, dtype=torch.float32, device=dev)
    if dynamic:
        xs = xz = qx  # not read
    else:
        xs = act_scale.to(device=dev, dtype=torch.float32).contiguous()
        xz = act_zp.to(device=dev, dtype=torch.int32).contiguous()
    vec_x = int(xc.data_ptr() % 16 == 0 and kdim % 4 == 0)
    out = _i8mm_launch(xc, b, qx, scale, zp, mode, qstrides, 0.0, None, plan, vec_x,
                       (xs, xz, act_qmin, act_qmax, _act_shift(act_qmax), int(dynamic)))
    return out, qx


def _quant(plain: bool):
    return act_quant_i8_plain if plain else act_quant_i8


def _product(a, b, qx, scale, zp, mode, qstrides, *, plain, window=0.0, conv_out=None):
    """:func:`_i8mm` in PyTorch ops (``plain``), else by the device: the
    ``i8mm`` operator while a program is traced, the kernel on a CUDA tensor,
    the plain version on a CPU one."""
    if not plain and torch.compiler.is_compiling():
        return torch.ops.jaxlsq_torch.i8mm(a, b, qx, scale, zp, mode, int(qstrides[0]),
                                           int(qstrides[1]), float(window),
                                           list(conv_out) if conv_out else [])
    return _i8mm(a, b, qx, scale, zp, mode, qstrides, plain=plain or not a.is_cuda,
                 window=window, conv_out=conv_out)


def _check_int8_pack(packed: PackedWeight, what: str) -> None:
    if packed.bits != 8 or packed.group_size is not None:
        raise ValueError(f"{what} needs an int8-packed weight")


def _quantized_product(x, b, scale, zp, act_scale, act_zp, act_qmin, act_qmax, dynamic,
                       qstrides, plain):
    """x (Bt, M, K) f32 quantized (static or dynamic) times the int8 b (Bt,
    K, N) with the matching epilogue: the fused ``i8mm`` where
    :func:`i8mm_plan` fuses (while a program is traced, the ``i8mm_fused``
    operator), else ``act_quant_i8`` then ``i8mm``; ``plain``: the plain
    versions."""
    batch, m, kdim = x.shape
    compiling = torch.compiler.is_compiling()
    if not plain and (x.is_cuda or compiling):
        plan = i8mm_plan(m, b.shape[2], kdim, batch, fused=True, sms=_sms(x.device))
        if plan.fused and compiling:
            return torch.ops.jaxlsq_torch.i8mm_fused(x, b, scale, zp, act_scale, act_zp,
                                                     int(act_qmin), int(act_qmax),
                                                     bool(dynamic), int(qstrides[0]),
                                                     int(qstrides[1]))
        if plan.fused:
            return _i8mm_fused(x, b, scale, zp, act_scale, act_zp, act_qmin, act_qmax,
                               dynamic, qstrides, plain=False, plan=plan)[0]
    xq, qx = _quant(plain)(x, act_scale, act_zp, act_qmin, act_qmax, dynamic=dynamic)
    return _product(xq, b, qx, scale, zp, "dynamic" if dynamic else "static", qstrides,
                    plain=plain)


def _static_int8_matmul(x, packed, act_scale, act_zp, act_qmin, act_qmax, out_dtype, plain):
    _check_int8_pack(packed, "static_int8_matmul")
    if act_scale.shape[0] != 1:
        raise ValueError("static activation qparams must be per-tensor")
    if len(packed.orig_shape) != 2:
        raise ValueError("static_int8_matmul needs a 2-D (K, N) packed weight")
    kdim, n = packed.orig_shape
    lead = x.shape[:-1]
    per_channel = packed.scale.numel() > 1
    out = _quantized_product(x.reshape(1, -1, kdim), packed.data[None], packed.scale,
                             packed.zero_point, act_scale, act_zp, act_qmin, act_qmax, False,
                             (0, int(per_channel)), plain)
    return out[0].to(out_dtype or x.dtype).reshape(*lead, n)


def static_int8_matmul(x: torch.Tensor, packed: PackedWeight, act_scale: torch.Tensor,
                       act_zp: torch.Tensor, act_qmin: int, act_qmax: int, *,
                       out_dtype=None) -> torch.Tensor:
    """Static-activation int8 x int8 matmul with the full dequant epilogue
    (the JAX package's ``static_int8_matmul``): x quantized with the frozen
    per-tensor (scale, zp), ``out = sx sw [x_q @ w_q - zpx colsum(w_q) - zpw
    rowsum(x_q) + K zpx zpw]``.  x (..., K) -> (..., N)."""
    if x.shape[-1] != packed.orig_shape[0]:
        raise ValueError(f"static_int8_matmul: x has K={x.shape[-1]}, "
                         f"weight K={packed.orig_shape[0]}")
    _check_device(x, "static_int8_matmul")
    if x.numel() == 0:
        return x.new_zeros(*x.shape[:-1], packed.orig_shape[1])
    return _static_int8_matmul(x, packed, act_scale, act_zp, act_qmin, act_qmax, out_dtype,
                               False)


def static_int8_matmul_plain(x, packed, act_scale, act_zp, act_qmin, act_qmax, *,
                             out_dtype=None):
    """:func:`static_int8_matmul` in PyTorch ops on any device."""
    return _static_int8_matmul(x, packed, act_scale, act_zp, act_qmin, act_qmax, out_dtype,
                               True)


def _dynamic_int8_matmul(x, packed, out_dtype, plain):
    _check_int8_pack(packed, "dynamic_int8_matmul")
    kdim, n = packed.orig_shape
    lead = x.shape[:-1]
    per_channel = packed.scale.numel() > 1
    out = _quantized_product(x.reshape(1, -1, kdim), packed.data[None], packed.scale,
                             packed.zero_point, None, None, -128, 127, True,
                             (0, int(per_channel)), plain)
    return out[0].to(out_dtype or x.dtype).reshape(*lead, n)


def dynamic_int8_matmul(x: torch.Tensor, packed: PackedWeight, *,
                        out_dtype=None) -> torch.Tensor:
    """Per-tensor dynamic activation quant + int8 x int8 matmul + fused
    dequant (the JAX package's ``dynamic_int8_matmul``): ``sx = max|x| /
    127``, ``x_q = round(x / sx)``, ``out = sx sw (x_q @ w_q - zpw
    rowsum(x_q))``.  The scale is taken over every row of the call."""
    if len(packed.orig_shape) != 2 or x.shape[-1] != packed.orig_shape[0]:
        raise ValueError(f"dynamic_int8_matmul: x has K={x.shape[-1]}, weight shape "
                         f"{tuple(packed.orig_shape)}")
    _check_device(x, "dynamic_int8_matmul")
    if x.numel() == 0:
        return x.new_zeros(*x.shape[:-1], packed.orig_shape[1])
    return _dynamic_int8_matmul(x, packed, out_dtype, False)


def dynamic_int8_matmul_plain(x, packed, *, out_dtype=None):
    """:func:`dynamic_int8_matmul` in PyTorch ops on any device."""
    return _dynamic_int8_matmul(x, packed, out_dtype, True)


def _static_int8_bmm(x, wq, scale, zero_point, act_scale, act_zp, act_qmin, act_qmax, plain):
    if act_scale.shape[0] != 1:
        raise ValueError("static activation qparams must be per-tensor")
    per_expert = scale.numel() > 1
    return _quantized_product(x, wq, scale, zero_point, act_scale, act_zp, act_qmin, act_qmax,
                              False, (int(per_expert), 0), plain)


def static_int8_bmm(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    zero_point: torch.Tensor, act_scale: torch.Tensor, act_zp: torch.Tensor,
                    act_qmin: int, act_qmax: int) -> torch.Tensor:
    """The stacked experts' static int8 x int8 product (the JAX package's
    ``_ExpertDense._serve_int8``): x (E, C, K) f32, ``wq`` int8 (E, K, N),
    per-expert (E,) or per-tensor (1,) weight qparams, the static epilogue
    of :func:`static_int8_matmul` per expert."""
    _check_device(x, "static_int8_bmm")
    return _static_int8_bmm(x, wq, scale, zero_point, act_scale, act_zp, act_qmin, act_qmax,
                            False)


def static_int8_bmm_plain(x, wq, scale, zero_point, act_scale, act_zp, act_qmin, act_qmax):
    """:func:`static_int8_bmm` in PyTorch ops on any device."""
    return _static_int8_bmm(x, wq, scale, zero_point, act_scale, act_zp, act_qmin, act_qmax,
                            True)


def same_padding(size: int, k: int, stride: int):
    """XLA's SAME padding of one spatial axis: ``ceil(size / stride)``
    outputs, the odd pixel of padding after (a stride-2 3x3 conv on an even
    size pads 0 before and 1 after; ``Conv2d(padding=1)`` would pad 1 and 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_pads(size_hw, kernel_hw, strides, padding):
    """((top, bottom), (left, right)) of 'SAME' (:func:`same_padding`),
    'VALID' or explicit pairs."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        return tuple(same_padding(n, k, s) for n, k, s in zip(size_hw, kernel_hw, strides))
    return tuple((int(p0), int(p1)) for p0, p1 in padding)


def conv_operands(xq: torch.Tensor, qx: torch.Tensor, packed: PackedWeight, strides, padding,
                  groups: int):
    """The int8 product's operands of a grouped conv: the windows of the
    NCHW int8 ``xq`` (padded with the integer zero point ``round(qx[1])``,
    the quantized real 0.0, so SAME padding agrees with the float path's zero
    padding) as (G, images * H' * W', kh * kw * cin_g) im2col rows, the HWIO
    pack as a (G, kh * kw * cin_g, cout / G) view, and (images, H', W')."""
    kh, kw, cin_g, cout = packed.orig_shape
    imgs, c, h, w = xq.shape
    if c != cin_g * groups or cout % groups:
        raise ValueError(f"static_int8_conv: {c} input channels, {groups} groups and a "
                         f"{tuple(packed.orig_shape)} kernel do not fit")
    sh, sw = (strides, strides) if isinstance(strides, int) else tuple(strides)
    (t, b), (l, r) = conv_pads((h, w), (kh, kw), (sh, sw), padding)
    if t or b or l or r:
        pad = _to_int8(torch.round(qx[1]))  # read on the device
        xp = torch.empty((imgs, c, h + t + b, w + l + r), dtype=torch.int8, device=xq.device)
        xp.copy_(pad.expand(xp.shape))
        xp[:, :, t:t + h, l:l + w] = xq
        xq = xp
    win = xq.unfold(2, kh, sh).unfold(3, kw, sw)  # (imgs, C, H', W', kh, kw)
    ho, wo = win.shape[2], win.shape[3]
    a = win.reshape(imgs, groups, cin_g, ho, wo, kh, kw).permute(1, 0, 3, 4, 5, 6, 2)
    a = a.reshape(groups, imgs * ho * wo, kh * kw * cin_g)
    bmat = packed.data.reshape(kh * kw * cin_g, groups, cout // groups).permute(1, 0, 2)
    return a, bmat, (imgs, ho, wo)


def _static_int8_conv(x, packed, act_scale, act_zp, act_qmin, act_qmax, strides, padding,
                      groups, out_dtype, plain):
    _check_int8_pack(packed, "static_int8_conv")
    if act_scale.shape[0] != 1:
        raise ValueError("static activation qparams must be per-tensor")
    quant = _quant(plain)
    xq, qx = quant(x, act_scale, act_zp, act_qmin, act_qmax)
    a, bmat, geom = conv_operands(xq, qx, packed, strides, padding, groups)
    ng = bmat.shape[2]
    per_channel = packed.scale.numel() > 1
    out = _product(a, bmat, qx, packed.scale, packed.zero_point, "conv",
                   (ng, 1) if per_channel else (0, 0), plain=plain,
                   window=float(a.shape[2]), conv_out=geom)
    return out.to(out_dtype or x.dtype)


def static_int8_conv(x: torch.Tensor, packed: PackedWeight, act_scale: torch.Tensor,
                     act_zp: torch.Tensor, act_qmin: int, act_qmax: int, *, strides=(1, 1),
                     padding="SAME", feature_group_count: int = 1,
                     out_dtype=None) -> torch.Tensor:
    """Static-activation int8 x int8 convolution with the dequant epilogue
    (the JAX package's ``static_int8_conv``) of NCHW ``x`` and the HWIO
    (kh, kw, cin / groups, cout) pack, per-channel qparams on cout:
    ``out = sx sw[c] (acc - zpx' colsum(w_q)[c] - zpw[c] (xwin - zpx' kh kw
    cin_g))``, the last term only for a column whose zero point is not 0
    (``xwin`` the window sum of x_q, the row sum of the group's im2col
    rows).  SAME padding uses the integer zero point, so it agrees with the
    float path's zero padding."""
    if x.dim() != 4:
        raise ValueError("static_int8_conv takes NCHW activations")
    _check_device(x, "static_int8_conv")
    return _static_int8_conv(x, packed, act_scale, act_zp, act_qmin, act_qmax, strides,
                             padding, feature_group_count, out_dtype, False)


def static_int8_conv_plain(x, packed, act_scale, act_zp, act_qmin, act_qmax, *,
                           strides=(1, 1), padding="SAME", feature_group_count: int = 1,
                           out_dtype=None):
    """:func:`static_int8_conv` in PyTorch ops on any device."""
    return _static_int8_conv(x, packed, act_scale, act_zp, act_qmin, act_qmax, strides,
                             padding, feature_group_count, out_dtype, True)
