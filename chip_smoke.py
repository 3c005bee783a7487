#!/usr/bin/env python3
"""Smoke test of the jaxlsq_torch port on one NVIDIA GPU (H100): the serving
slice, paged-KV serving of a group-wise int4 LM, the QAT training slice, its
single-program (CUDA-graph) step, long-context LSQ QAT of the LM through
the flash-attention kernels, then serving the trained LM; jaxlsq's headline
fake-quant fwd+bwd chain through the fused kernel, and the int4 kernel lab.

    python3 chip_smoke.py [--record PATH]

Runs from the root of a checkout, needs one CUDA card, imports no jax, and
exits non-zero on any failure (no phase is caught and skipped):

1. prints the card (``nvidia-smi`` name and power limit) and turns TF32 off
   for matmuls and cuDNN convolutions;
2. builds the CUDA kernels from ``jaxlsq_torch/csrc`` and holds each against
   its plain PyTorch version at the main paths' shapes: ``wo8``/``wo4`` at
   M in {1, 8, 256} over every K x N of the d1024 LM plus an odd K, and
   ``wo4g`` (group 128) at the same M and K x N within 1e-4 of max|ref|;
   ``decode_attention`` for every cache carrier, a scalar index at B = 1
   and a per-slot index at B = 8, t in {1, 32}, L in {240, 2048}, and two
   windows; paged attention at B = 8, L = 2048 over permuted tables, page
   sizes 16, 128 and 1024, every carrier, t = 1 and t = 32 with a 256-key
   window, within 1e-5 of its plain version and bit-equal to
   ``decode_attention`` on the gathered cache; the four fake-quant kernels at all 42 quantizer shapes of
   ``resnet18_cifar`` at B = 64 (21 activation inputs, 21 weights), in
   train, eval and init modes, and their four traced twins (modes read
   from a device flag tensor) for the four (eval, init) flag pairs, on
   random data and on the real activations, weights and gradients of one
   eager training step (forward and dX bit-exact, dS/dB within 1e-5 of the
   sum of the magnitudes of their terms), and the fused fwd+bwd kernels
   (``fq_fwdbwd_pt``/``_pc``) in train mode at the same shapes and data,
   bit-equal to the static forward and backward kernels;
3. drives the serving path with every launch count reset: the d1024 x 4 LM
   of the JAX package's decode benchmark (vocab 8192, 16 heads, max_len
   240, int8 per-channel weights, bf16 cache, seeded random weights) through
   ``make_generate`` at B = 1 and 8 (tokens/s from the 16 -> 208 token
   slope), ``DecodeEngine`` (8 requests, each checked token for token
   against ``make_generate`` at B = 1), the int4-weight LM at B = 1, and the
   max_len 2048, B = 8 leg with int8 and int4 caches (and the kernels a
   decode step launches in the int4 and the B = 8 legs); checks the kernel
   path's logits against the plain path on the CPU; fails if a kernel of
   the path was never launched; profiles one B = 1 generate for the
   device's busy share and the time by kernel;
4. drives the paged serving path with every launch count reset: the d1024
   x 4 LM converted with ``weight_group_size=128`` (every dense kernel
   group-wise int4, the embedding int8; max_len 2048) served by
   ``PagedDecodeEngine`` (max_batch 8, int8 pools, page 128, 16 pool pages
   of a dense-equivalent 128) over 16 seeded requests (prompts 4-128, 16-200
   new tokens), 8 of them on a registered 228-token prefix (a whole page
   shared, a 100-token partial page copied); fails unless the tokens equal
   ``DecodeEngine``'s on the same stream, admissions were deferred, prefix
   pages were shared, and ``wo4g`` and the paged kernel ran and ``wo4``,
   ``wo8`` and ``decode_attention`` did not; then bench.py's B = 8,
   L = 2048 paged generate loop beside the dense int8 loop (interleaved
   rounds, tokens equal) and the paged kernel path's logits within
   1e-4 of max|ref| of the CPU plain path;
5. times each kernel at the main paths' shapes (L2 flushed by rotating
   buffer copies): device time from CUDA events around calls issued behind
   a sleep kernel (so they run back to back) and time a call from CUDA
   events around calls issued as the host can, beside its bound, its plain
   version and one PyTorch library call (the traced fake-quant kernels in
   train mode beside the static ones, the per-channel ones also on the LM
   head's (512, 8192) weight on axis 1; the paged kernel in turns with the
   dense kernel on the same contents at page sizes 16, 128 and 1024, and at
   B = 1, L = 8192; attention also at int8, B = 1, L = 8192; ``wo4g`` also
   at K = N = 8192, M = 1, beside phase 12's ``wo4``; ``wo8``/``wo4``
   beside their tensor-core bound, three bf16 passes, with the f32
   CUDA-core bound beside it, and each ``wo*``'s sums over the five d1024
   shapes at M = 1, 8 and 256 beside ``torch.matmul``'s);
6. drives the eager training path (``make_train_step(jit=False)``) with
   every launch count reset: full-width
   ``resnet18_cifar`` under ``default_qconfig(8, 8, per_channel_weights=True,
   init_batches=2)``, seeded on the card, SGD (lr 1e-2, momentum 0.9),
   B = 64 seeded random 32x32x3 images and labels, 12 steps (the 2-batch
   observer window, then full LSQ; steps/s and images/s over steps 3-12)
   and one profiled step (busy share, time by kernel); fails unless every
   loss is finite and each fake-quant kernel ran 21 times a step past the
   window (in it ``fq_bwd_pt`` 20: the stem's activation quantizer reaches
   no parameter there); then one B = 8 step from the same state on the card and on the
   CPU plain path, the losses within 1e-3 relative (where a rounding
   boundary fell the other way, the CPU takes the card's activation, at
   most one quant step away, on at most 1e-5 of the elements); the step's
   convolution FLOPs and its BatchNorm layers' device time alone;
7. drives the captured training path (``make_train_step(jit=True)``) with
   every launch count reset: phase 6's model, seed, batches and 12 steps
   (step 1 an eager warm-up, step 2 the capture and its first replay,
   steps 3-12 replays; steps/s and images/s over steps 3-12); fails unless
   every loss is finite, each traced kernel was launched 21 times by the
   warm-up and 21 by the capture and never by a replay, one graph ran every
   replay and the observer-window -> LSQ switch happened inside one (step
   3), a profiled replay ran the traced kernels (one a backward, no sum
   kernel) and no static one, and
   ``disable_fake_quant_on_act`` between two replays zeroed the activation
   qparams' gradients without a new capture;
8. the eager and the captured step from one state, cuDNN deterministic on
   both sides, 5 steps across the switch and a toggle: losses, every
   parameter and buffer (qparams, BatchNorm statistics, counters, flags,
   observer state) and the optimizer's state equal; for phase 7's SGD, and
   under an lr that changes before every step (the captured side writes
   Python floats into ``group['lr']``) for SGD (momentum 0.9, weight decay
   1e-2, ``fused=True``) and AdamW (weight decay 1e-2, ``capturable=True``),
   whose decay reaches the qparams across the window's end;
9. checks (with phase 2) the two flash-attention kernels (3xTF32 products
   on the tensor cores; the backward one launch) against their plain
   versions at (B, H, t, hd) = (2, 8, 4096, 64), (4, 8, 2048, 64) and t in
   {60, 1000} for hd in {32, 64, 128} (out and lse within 2e-5 of max|ref|,
   dQ/dK/dV within 1e-4; the backward bit-equal across two runs), and the
   fake-quant kernels at the 19 quantizer shapes of the LM below (its real
   data from one step and random data; the phase 2 gates); then drives the
   LM path with every launch count reset: ``QuantTransformerLM`` at the
   widths of docs/measurements/flash_train_tpu.json (vocab 8192, d512,
   depth 2, 8 heads, rope) under ``default_qconfig(8, 8,
   per_channel_weights=True, init_batches=2)``, SGD (lr 1e-2, momentum
   0.9), seeded tokens (labels shifted by one), 8 eager and then 8 captured
   steps of fresh models under ``'flash'`` and ``'xla'`` at B = 2, t = 4096
   and B = 4, t = 2048 (tokens/s over steps 3-8, peak allocated memory, a
   profiled step of the t = 4096 ``'flash'`` legs, naming their attention
   kernels); fails unless every loss is finite and each flash kernel ran
   ``depth`` times a step eagerly, ``depth`` times in the warm-up and in
   the capture and never in a replay; then a B = 1, t = 512 step on the
   card against the CPU plain path (phase 6's rule), 3 eager and 3 captured
   steps from one state equal leaf by leaf, ``attn_window=512`` taking the
   banded path (no flash launch), and train-then-serve: the trained
   variables into a serve-mode LM (``load_variables``), ``make_generate`` at
   B = 1, logits within 1e-4 of max|ref| of the CPU plain path, ``wo8`` and
   ``decode_attention`` launched;
10. times the flash kernels at the LM's two shapes beside their bounds
   (3xTF32 on the tensor cores, and f32 on the CUDA cores), plain versions
   and SDPA (forward, backward alone, forward + backward; its kernels named
   from a profile);
11. jaxlsq's headline chain (bench.py:484-628) with every launch count
   reset: per tensor (0..255, 64 Mi f32 elements as (65536, 1024), s0 = 0.1,
   b0 = 0.05) and per channel (the resnet weight spec on an (8192, 8192)
   weight), out -> y, dX -> g, s and b stepped by 1e-6 of their gradients;
   fails unless after 8 iterations the fused leg (``fake_quant_fwdbwd``) and
   the split leg (autograd: ``fq_fwd`` + ``fq_bwd``) agree bit for bit in
   y, g, s and b, are finite, and each launched only its own kernels, and
   unless one fused call on the chain's inputs matches the plain pair on the
   card (out and dX bit-equal, dS/dB within 1e-5 of their term sums); then
   the split, fused, plain and library legs timed as the slope between 2 and
   8 iterations (interleaved rounds, min of 5), a one-read-one-write stream
   probe, GB/s at the canonical 20 B an element, the fused leg's real rate at
   16 B, and the fused kernel alone beside its bound, the split pair, its
   plain version and the library's learnable fake quant;
12. the int4 kernel lab (``jaxlsq_torch.lab.int4_kernel_lab``) at M in {1,
   16, 128}, K = N = 8192 with every launch count reset: ``wo8``, ``wo4``,
   ``wo4_bf16`` and ``wo4_native`` against ``wo_matmul_plain`` at their own
   bits; fails unless ``wo4_bf16`` and ``wo4_native`` are within
   1e-4·max|ref| of their plain versions and ``wo4_native`` of ``wo4`` on the
   same values, and unless every row of both lab kernels is the same bits at
   M = 1, 16 and 128; device time and weight GB/s of each beside the plain
   versions, ``torch.matmul`` on dequantized f32 and bf16 weights and the
   lab kernels' tensor-core bounds (one bf16 pass for ``wo4_bf16``, three
   for ``wo4_native``).

Prints one ``{"kernels": [...]}`` JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  ``--record PATH`` also writes the full
record (every check, time and profile) to PATH as JSON.
"""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# the card's timing method, shared with the kernel labs (fails outside a checkout)
from jaxlsq_torch.lab.timing import (PROFILE_MISSES, WAITING_CALLS,  # noqa: E402
                                     device_profile, events_ms, kernel_ms, measure,
                                     profiled)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM dense TF32 on the tensor cores
BF16_FLOPS = 989e12         # H100 SXM dense bf16 on the tensor cores
VOCAB, DIM, DEPTH, HEADS, T0 = 8192, 1024, 4, 16, 32
GROUP = 128  # convert(weight_group_size=) of the grouped-int4 LM
# PagedDecodeEngine leg: a page of 128 positions, 16 pool pages (an eighth of
# the dense-equivalent 8 x 2048 / 128 = 128, so admissions defer), a prefix of
# one whole page plus a 100-token partial page
PAGE, NUM_PAGES, PREFIX_LEN = 128, 16, 228
N1, N2 = 16, 208
WO_SHAPES = {"qkv": (1024, 3072), "proj": (1024, 1024), "mlp_up": (1024, 4096),
             "mlp_down": (4096, 1024), "lm_head": (1024, 8192)}
TRAIN_B, TRAIN_STEPS, CHECK_B = 64, 12, 8
MAX_MOVED_SHARE = 1e-5  # of a B = CHECK_B step's activation elements (53 of 5,337,088)
FQ_KERNELS = ("fq_fwd_pt", "fq_fwd_pc", "fq_bwd_pt", "fq_bwd_pc")
TRACED_KERNELS = tuple(f"{k}_traced" for k in FQ_KERNELS)
FUSED_KERNELS = ("fq_fwdbwd_pt", "fq_fwdbwd_pc")
FLAG_PAIRS = ((0, 0), (1, 0), (0, 1), (1, 1))  # (eval, init)
EQUAL_STEPS = 5
# the long-context QAT leg: docs/measurements/flash_train_tpu.json's LM
LM_VOCAB, LM_DIM, LM_DEPTH, LM_HEADS, LM_MAX = 8192, 512, 2, 8, 4096
LM_LEGS = ((2, 4096), (4, 2048))  # (B, t): 8192 tokens a step
LM_STEPS = 8
FLASH_KERNELS = ("flash_fwd", "flash_bwd")
FLASH_SHAPES = ((2, 8, 4096, 64), (4, 8, 2048, 64), (2, 8, 60, 64), (2, 8, 1000, 64),
                (2, 8, 60, 32), (2, 8, 1000, 32), (2, 8, 60, 128), (2, 8, 1000, 128))
# jaxlsq's headline fwd+bwd chain (bench.py:484-628): 64 Mi f32 elements,
# per tensor; its per-channel twin on an (out, in) weight of the same size
CHAIN_SHAPE, CHAIN_PC_SHAPE = (65536, 1024), (8192, 8192)
CHAIN_K1, CHAIN_K2, CHAIN_ROUNDS = 2, 8, 5
CANON_BYTES, FUSED_BYTES = 20, 16  # per element: the split pair, the fused pass
# the int4 kernel lab (examples/_int4_kernel_lab.py) at decode and prefill M
LAB_MS, LAB_K, LAB_N, LAB_ROUNDS = (1, 16, 128), 8192, 8192, 5


def reset_counts():
    """Every kernel wrapper's launch count to 0; returns the count dicts."""
    from jaxlsq_torch.lab.int4_kernel_lab import LAUNCHES as LAB
    from jaxlsq_torch.ops.fake_quant import LAUNCHES as FQ
    from jaxlsq_torch.ops.flash_attention import LAUNCHES as FLASH
    from jaxlsq_torch.serve.attention import LAUNCHES as ATTN
    from jaxlsq_torch.serve.matmul import LAUNCHES as MM
    from jaxlsq_torch.serve.paged import LAUNCHES as PAGED

    for counts in (MM, ATTN, FQ, PAGED, FLASH, LAB):
        for k in counts:
            counts[k] = 0
    return MM, ATTN, FQ


def log(*a):
    print(*a, flush=True)


def bound(nbytes, flops):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def copies_for(nbytes, floor=160e6):
    return max(1, min(64, math.ceil(floor / max(nbytes, 1))))


def phase_kernels(torch, rec):
    from jaxlsq_torch import _build
    from jaxlsq_torch.core.spec import QuantSpec
    from jaxlsq_torch.serve.attention import decode_attention, decode_attention_plain
    from jaxlsq_torch.serve.matmul import wo_matmul, wo_matmul_plain
    from jaxlsq_torch.serve.pack import quantize_weight, quantize_weight_grouped

    t0 = time.time()
    _build.load_library()
    rec["build_s"] = time.time() - t0
    log(f"[build] kernels built and loaded in {rec['build_s']:.1f} s")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    errs = {"wo8": 0.0, "wo4": 0.0, "wo4g": 0.0, "decode_attention": 0.0,
            "paged_attention": 0.0}
    for bits, name in ((8, "wo8"), (4, "wo4")):
        spec = QuantSpec.weight_default(bits, per_channel=True, axis=1)
        shapes = list(WO_SHAPES.values()) + [(1023, 520)]
        for k, n in shapes:
            w = torch.randn(k, n, device=dev, generator=g) * k ** -0.5
            p = quantize_weight(w, w.abs().amax(0) / spec.quant_max,
                                torch.zeros(n, device=dev), spec, bits=bits)
            for m in (1, 8, 256):
                x = torch.randn(m, k, device=dev, generator=g)
                out = wo_matmul(x, p)
                ref = wo_matmul_plain(x, p)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                tol = 1e-4 * float(ref.abs().max())
                log(f"[check] {name} M={m} K={k} N={n}: max_abs_err {err:.3e} "
                    f"(tol {tol:.3e})")
                if not err <= tol:
                    raise AssertionError(f"{name} disagrees with its plain version")
                errs[name] = max(errs[name], err)
    for k, n in WO_SHAPES.values():  # wo4g: the grouped-int4 LM's layers
        w = torch.randn(k, n, device=dev, generator=g) * k ** -0.5
        p = quantize_weight_grouped(w, group_size=GROUP)
        for m in (1, 8, 256):
            x = torch.randn(m, k, device=dev, generator=g)
            out = wo_matmul(x, p)
            ref = wo_matmul_plain(x, p)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            tol = 1e-4 * float(ref.abs().max())
            log(f"[check] wo4g M={m} K={k} N={n} group {GROUP}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e})")
            if not err <= tol:
                raise AssertionError("wo4g disagrees with its plain version")
            errs["wo4g"] = max(errs["wo4g"], err)
    hd = 64
    cases = []
    for carrier in ("f32", "bf16", "int8", "int4"):
        for per_slot in (False, True):
            for t in (1, 32):
                for length in (240, 2048):
                    cases.append((carrier, per_slot, t, length, None))
    cases.append(("int8", True, 1, 2048, 256))
    cases.append(("bf16", False, 32, 240, 64))
    for carrier, per_slot, t, length, window in cases:
        b = 8 if per_slot else 1  # B = 1 is make_generate's single-prompt path
        q = torch.randn(b, HEADS, t, hd, device=dev, generator=g)
        ck, cv = (_rand_cache(torch, carrier, b, HEADS, length, hd, g) for _ in "kv")
        if per_slot:
            idx = torch.randint(0, length - t + 1, (b,), device=dev,
                                generator=g).to(torch.int32)
        else:
            idx = int(torch.randint(0, length - t + 1, (1,), generator=g,
                                    device=dev))
        out = decode_attention(q, ck, cv, idx, window=window)
        ref = decode_attention_plain(q, ck, cv, idx, window=window)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        log(f"[check] decode_attention {carrier} {'per-slot' if per_slot else 'scalar'}"
            f" B={b} t={t} L={length} window={window}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError("decode_attention disagrees with its plain version")
        errs["decode_attention"] = max(errs["decode_attention"], err)
    errs["paged_attention"] = _check_paged(torch, g)
    rec["max_abs_err"] = errs


def _rand_pool(torch, carrier, b, kvh, length, hd, ps, g):
    """A paged layer of B slots over ``length`` positions: random rows in
    every page of the pool, a permuted table, a spare page no slot maps."""
    from jaxlsq_torch.serve.paged import PagedKVLayer

    pps = -(-length // ps)
    n_pages = b * pps + 1
    table = torch.randperm(n_pages, device=g.device, generator=g)[:b * pps]
    table = table.reshape(b, pps).to(torch.int32)
    kp, vp = (_rand_cache(torch, carrier, n_pages, kvh, ps, hd, g) for _ in "kv")
    if isinstance(kp, tuple):
        return PagedKVLayer(kp=kp[0], vp=vp[0], ks=kp[1], vs=vp[1], table=table,
                            page_size=ps)
    return PagedKVLayer(kp=kp, vp=vp, table=table, page_size=ps)


def _check_paged(torch, g):
    """Paged attention at B = 8, L = 2048 against its plain version (within
    1e-5) and bit-equal to ``decode_attention`` on the gathered cache: page
    sizes 16, 128, 1024, every carrier, t = 1 with no window and t = 32 with
    a 256-key window, per-slot positions."""
    from jaxlsq_torch.serve.attention import decode_attention
    from jaxlsq_torch.serve.paged import (_gather_dense, paged_attention,
                                          paged_attention_plain)

    worst = 0.0
    b, length, hd = 8, 2048, 64
    for ps in (16, 128, 1024):
        for carrier in ("f32", "bf16", "int8", "int4"):
            for t, window in ((1, None), (32, 256)):
                layer = _rand_pool(torch, carrier, b, HEADS, length, hd, ps, g)
                q = torch.randn(b, HEADS, t, hd, device=g.device, generator=g)
                idx = torch.randint(0, length - t + 1, (b,), device=g.device,
                                    generator=g).to(torch.int32)
                out = paged_attention(q, layer, idx, window=window)
                ref = paged_attention_plain(q, layer, idx, window=window)
                ck, cv = _gather_dense(layer)
                dense = decode_attention(q, ck, cv, idx, window=window)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                tol = 1e-5 * max(1.0, float(ref.abs().max()))
                same = bool(torch.equal(out, dense))
                log(f"[check] paged_attention {carrier} page {ps} B={b} t={t} "
                    f"L={length} window={window}: max_abs_err {err:.3e} (tol "
                    f"{tol:.3e}), bit-equal to decode_attention: {same}")
                if not (err <= tol and same):
                    raise AssertionError("paged_attention disagrees with its plain "
                                         "version or with the dense kernel")
                worst = max(worst, err)
    return worst


def _rand_cache(torch, carrier, b, kvh, length, hd, g):
    dev = g.device
    if carrier in ("f32", "bf16"):
        dt = torch.float32 if carrier == "f32" else torch.bfloat16
        return torch.randn(b, kvh, length, hd, device=dev, generator=g).to(dt)
    width, lo, hi, dt = ((hd, -127, 128, torch.int8) if carrier == "int8"
                         else (hd // 2, 0, 256, torch.uint8))
    return (torch.randint(lo, hi, (b, kvh, length, width), device=dev,
                          generator=g).to(dt),
            torch.rand(b, kvh, length, device=dev, generator=g) * (0.02 if carrier == "int8" else 0.3))


def _lm(torch, wbits, max_len, seed, group=None):
    """The d1024 LM with seeded variables; with ``group`` its QAT tree is
    converted with ``weight_group_size=group`` (``variables`` is then the
    converted tree)."""
    from jaxlsq_torch import interop
    from jaxlsq_torch.models import QuantTransformerLM, default_qconfig, init_variables
    from jaxlsq_torch.serve import convert

    qc = default_qconfig(wbits, 8, per_channel_weights=True).for_serving("none")
    model = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, qc, max_len=max_len,
                               device="cuda")
    variables = init_variables(model, seed=seed)
    if group is not None:
        variables = convert(variables, qc, weight_group_size=group)
    interop.load_variables(model, variables)
    return model, variables, qc


def _slope_tps(torch, model, b, prompt, cache_dtype, n1=N1, n2=N2, rounds=3):
    """Decode tokens/s from the slope between two generation lengths (cancels
    prefill and fixed costs), min over interleaved rounds."""
    from jaxlsq_torch.serve import make_generate

    g1 = make_generate(model, prompt.shape[1], n1, cache_dtype=cache_dtype)
    g2 = make_generate(model, prompt.shape[1], n2, cache_dtype=cache_dtype)
    out = g2(prompt)
    g1(prompt)
    torch.cuda.synchronize()
    t1, t2 = [], []
    for _ in range(rounds):
        s = time.perf_counter(); g1(prompt).cpu(); t1.append(time.perf_counter() - s)
        s = time.perf_counter(); g2(prompt).cpu(); t2.append(time.perf_counter() - s)
    dt = (min(t2) - min(t1)) / (n2 - n1)
    return b / dt, out, {"t_n1_s": t1, "t_n2_s": t2}


def phase_main(torch, rec):
    import numpy as np

    from jaxlsq_torch import interop
    from jaxlsq_torch.models import QuantTransformerLM
    from jaxlsq_torch.serve import DecodeEngine, make_generate, prefill
    from jaxlsq_torch.serve.attention import LAUNCHES as ATTN
    from jaxlsq_torch.serve.matmul import LAUNCHES as MM

    dev = torch.device("cuda")
    main = {}
    rec["main"] = main
    model, variables, qc = _lm(torch, 8, T0 + N2, seed=0)
    r = np.random.RandomState(7)
    reset_counts()
    t_main = time.time()

    # make_generate, greedy, B = 1 and 8, bf16 cache
    for b in (1, 8):
        prompt = torch.as_tensor(r.randint(0, VOCAB, size=(b, T0)), device=dev)
        tps, toks, raw = _slope_tps(torch, model, b, prompt, torch.bfloat16)
        toks = toks.cpu().numpy()
        if toks.shape != (b, N2) or not ((toks >= 0) & (toks < VOCAB)).all():
            raise AssertionError(f"generate B={b}: bad tokens {toks.shape}")
        main[f"decode_tokens_per_s_b{b}_int8"] = tps
        main[f"decode_raw_b{b}_int8"] = raw
        log(f"[main] make_generate int8 weights, bf16 cache, B={b}: "
            f"{tps:.1f} tokens/s (slope {N1}->{N2})")

    # where a B = 1 decode's time goes: device busy share, time by kernel
    prompt = torch.as_tensor(r.randint(0, VOCAB, size=(1, T0)), device=dev)
    main["profile_b1"] = _profile_generate(torch, model, prompt)
    p = main["profile_b1"]
    log(f"[main] profiled B=1 generate of {N2} tokens: wall {p['wall_ms']:.1f} ms, "
        f"device busy {p['device_ms']:.1f} ms ({100 * p['busy_share']:.1f}%), "
        f"{p['kernels_per_token']:.1f} kernels a token; top: "
        + "; ".join(f"{k} {v:.1f} ms" for k, v in p["top"][:6]))

    # DecodeEngine: 8 requests, each equal to make_generate at B = 1
    reqs = [(r.randint(0, VOCAB, size=int(r.randint(4, 33))), int(r.randint(16, 49)))
            for _ in range(8)]
    with DecodeEngine(model, max_batch=8, prompt_buckets=(8, 32),
                      cache_dtype=torch.bfloat16) as eng:
        eng.warmup()
        s = time.perf_counter()
        futs = [eng.submit(p, n) for p, n in reqs]
        outs = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - s
        stats = dict(eng.stats)
    n_tok = sum(len(o) for o in outs)
    for (p, n), got in zip(reqs, outs):
        want = make_generate(model, len(p), n, cache_dtype=torch.bfloat16)(
            torch.as_tensor(p, device=dev)[None])[0].cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"engine tokens differ from make_generate for a "
                                 f"{len(p)}-token prompt: {got} vs {want}")
    main["engine"] = {"requests": len(reqs), "tokens": n_tok, "wall_s": wall,
                      "tokens_per_s": n_tok / wall, "steps": stats["steps"],
                      "mean_active_slots": stats["active_token_sum"] / max(1, stats["steps"])}
    log(f"[main] DecodeEngine: {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s "
        f"({n_tok / wall:.1f} tokens/s); every request equals make_generate at B=1")

    # the kernel path against the plain path on the CPU, on a short prompt
    cpu_model = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, qc, max_len=T0 + N2,
                                   device="cpu")
    interop.load_variables(cpu_model, _to_cpu(torch, variables))
    prompt = torch.as_tensor(r.randint(0, VOCAB, size=(1, 16)))
    got, cache, idx = prefill(model, prompt.to(dev))
    want, ccache, _ = prefill(cpu_model, prompt)
    tok = torch.argmax(want, -1).to(torch.int32)[:, None]
    with torch.no_grad():
        g2, _ = model(tok.to(dev), cache=cache, cache_index=idx)
        w2, _ = cpu_model(tok, cache=ccache, cache_index=idx)
    for a, b_ in ((got, want), (g2[:, -1], w2[:, -1])):
        a = a.cpu()
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite logits")
        err = float((a - b_).abs().max())
        tol = 1e-4 * float(b_.abs().max())
        log(f"[main] logits vs plain CPU path (f32 cache): max_abs_err {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError("kernel-path logits disagree with the plain path")
    main["logits_err_vs_cpu"] = err

    # int4 weights, B = 1
    model4, _, _ = _lm(torch, 4, T0 + N2, seed=1)
    prompt = torch.as_tensor(r.randint(0, VOCAB, size=(1, T0)), device=dev)
    tps, _, raw = _slope_tps(torch, model4, 1, prompt, torch.bfloat16)
    main["decode_tokens_per_s_b1_int4"] = tps
    main["decode_raw_b1_int4"] = raw
    per_step = _kernels_per_step(torch, lambda n: make_generate(
        model4, T0, n, cache_dtype=torch.bfloat16)(prompt), 16, 80)
    main["kernels_per_step_b1_int4"] = per_step
    log(f"[main] make_generate int4 weights, bf16 cache, B=1: {tps:.1f} tokens/s; "
        f"{per_step:.1f} kernels a decode step")
    del model4

    # max_len 2048, B = 8, int8 and int4 caches, short generate
    longm, _, _ = _lm(torch, 8, 2048, seed=3)
    prompt = torch.as_tensor(r.randint(0, VOCAB, size=(8, T0)), device=dev)
    for cdt in (torch.int8, "int4"):
        tps, toks, raw = _slope_tps(torch, longm, 8, prompt, cdt, n1=16, n2=80,
                                    rounds=2)
        name = "int8" if cdt is torch.int8 else "int4"
        main[f"decode_tokens_per_s_b8_L2048_{name}kv"] = tps
        main[f"decode_raw_b8_L2048_{name}kv"] = raw
        per_step = _kernels_per_step(torch, lambda n: make_generate(
            longm, T0, n, cache_dtype=cdt)(prompt), 16, 80)
        main[f"kernels_per_step_b8_L2048_{name}kv"] = per_step
        log(f"[main] max_len 2048, B=8, {name} cache: {tps:.1f} tokens/s "
            f"(slope 16->80); {per_step:.1f} kernels a decode step")
    del longm
    torch.cuda.synchronize()
    main["wall_s"] = time.time() - t_main
    rec["launches"] = {"wo8": MM["wo8"], "wo4": MM["wo4"], **ATTN}
    log(f"[main] kernel launches on the main path: {rec['launches']}")
    for k, v in rec["launches"].items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was never launched on the main path")


def _kernels_per_step(torch, run, n1, n2):
    """Kernels a decode step: the profiles' kernel counts of ``run(n2)`` less
    ``run(n1)`` over the n2 - n1 extra steps; the larger of two profiles
    each (a lost stretch of records only lowers a count)."""
    def count(n):
        return max(sum(e.count for e in profiled(lambda: run(n))[0]) for _ in range(2))

    return (count(n2) - count(n1)) / (n2 - n1)


def _engine_run(eng, reqs, prefix_toks):
    """Register the prefix, submit ``reqs`` ((prompt, n_new, with prefix)),
    and return (outputs, wall s, stats)."""
    eng.warmup()
    h = eng.register_prefix(prefix_toks)
    s = time.perf_counter()
    futs = [eng.submit(p, n, prefix=h if shared else None) for p, n, shared in reqs]
    outs = [f.result(timeout=600) for f in futs]
    return outs, time.perf_counter() - s, dict(eng.stats)


def _paged_generate(torch, model, prompt, n_new, page_size):
    """bench.py's paged_generate: prefill a B-row prompt into int8 page pools
    of the dense-equivalent layout, then greedy decode steps."""
    from jaxlsq_torch.serve import init_paged_cache, prefill

    cache = init_paged_cache(model, prompt.shape[0], page_size=page_size,
                             dtype=torch.int8)
    last, cache, idx = prefill(model, prompt, cache=cache)
    tok = torch.argmax(last, -1).to(torch.int32)
    toks = [tok]
    with torch.no_grad():
        for i in range(n_new - 1):
            logits, cache = model(tok[:, None], cache=cache, cache_index=idx + i)
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
            toks.append(tok)
    return torch.stack(toks, 1)


def phase_paged(torch, rec):
    """The slice's main path: the d1024 x 4 LM converted with
    ``weight_group_size=128`` (every dense kernel group-wise int4, the
    embedding int8) served by ``PagedDecodeEngine`` over int8 page pools,
    held token for token against ``DecodeEngine``; then bench.py's B = 8,
    L = 2048 paged generate loop beside the dense int8 loop, and the paged
    kernel path's logits against the CPU plain path."""
    import numpy as np

    from jaxlsq_torch import interop
    from jaxlsq_torch.models import QuantTransformerLM
    from jaxlsq_torch.serve import (DecodeEngine, PagedDecodeEngine,
                                    init_paged_cache, make_generate, prefill)
    from jaxlsq_torch.serve.attention import LAUNCHES as ATTN
    from jaxlsq_torch.serve.matmul import LAUNCHES as MM
    from jaxlsq_torch.serve.paged import LAUNCHES as PAGED

    dev = torch.device("cuda")
    paged = {}
    rec["paged"] = paged
    model, variables, qc = _lm(torch, 4, 2048, seed=5, group=GROUP)
    kinds = {n: m.kernel.packed().group_size
             for n, m in model.named_modules() if hasattr(m, "kernel")}
    if set(kinds.values()) != {GROUP} or model.tok_emb.embedding.bits != 8:
        raise AssertionError(f"not every dense kernel is grouped: {kinds}")
    r = np.random.RandomState(11)
    prefix = r.randint(0, VOCAB, size=PREFIX_LEN)
    reqs = [(r.randint(0, VOCAB, size=int(r.randint(4, 129))),
             int(r.randint(16, 201)), i % 2 == 1) for i in range(16)]
    kw = dict(max_batch=8, prompt_buckets=(32, 128), cache_dtype=torch.int8)
    reset_counts()
    with PagedDecodeEngine(model, num_pages=NUM_PAGES, page_size=PAGE, **kw) as eng:
        outs, wall, stats = _engine_run(eng, reqs, prefix)
    torch.cuda.synchronize()
    launches = {"wo4g": MM["wo4g"], **PAGED, "wo4": MM["wo4"], "wo8": MM["wo8"], **ATTN}
    paged["launches"] = launches
    with DecodeEngine(model, **kw) as eng:
        want, dwall, dstats = _engine_run(eng, reqs, prefix)
    n_tok = sum(len(o) for o in outs)
    same = all(np.array_equal(a, b) for a, b in zip(outs, want))
    paged["engine"] = {
        "requests": len(reqs), "tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall, "dense_wall_s": dwall,
        "dense_tokens_per_s": n_tok / dwall, "steps": stats["steps"],
        "dense_steps": dstats["steps"], "equal_to_dense": same,
        **{k: stats[k] for k in ("admissions_deferred", "prefix_pages_shared",
                                 "window_pages_freed", "admission_chunks")}}
    e = paged["engine"]
    log(f"[paged] PagedDecodeEngine, grouped-int4 d1024 x 4 LM, int8 pools "
        f"(page {PAGE}, {NUM_PAGES} pages of a dense-equivalent "
        f"{8 * 2048 // PAGE}), {len(reqs)} requests (8 on a {PREFIX_LEN}-token "
        f"prefix): {n_tok} tokens in {wall:.3f} s ({e['tokens_per_s']:.1f} "
        f"tokens/s; DecodeEngine {e['dense_tokens_per_s']:.1f}), "
        f"{e['admissions_deferred']} admissions deferred, "
        f"{e['prefix_pages_shared']} prefix pages shared; tokens equal to "
        f"DecodeEngine's: {same}; launches {launches}")
    if not same:
        raise AssertionError("PagedDecodeEngine's tokens differ from DecodeEngine's")
    if not (e["admissions_deferred"] > 0 and e["prefix_pages_shared"] > 0):
        raise AssertionError(f"no deferral or no shared prefix page: {e}")
    if not (launches["wo4g"] > 0 and launches["paged_attention"] > 0
            and launches["paged_attention_fold"] == launches["paged_attention"]
            and launches["wo4"] == 0 and launches["wo8"] == 0
            and launches["decode_attention"] == 0
            and launches["decode_attention_fold"] == 0):
        raise AssertionError(f"the paged path ran other kernels: {launches}")

    # bench.py's paged_generate beside the dense int8 loop, interleaved
    prompt = torch.as_tensor(r.randint(0, VOCAB, size=(8, T0)), device=dev)
    n1, n2 = 16, 80
    loops = {"dense": lambda n: make_generate(model, T0, n, cache_dtype=torch.int8)(prompt),
             "paged": lambda n: _paged_generate(torch, model, prompt, n, PAGE)}
    for f in loops.values():
        f(n1), f(n2)
    times = {k: ([], []) for k in loops}
    for _ in range(3):
        for k, f in loops.items():
            for i, n in enumerate((n1, n2)):
                torch.cuda.synchronize()
                s = time.perf_counter()
                f(n).cpu()
                times[k][i].append(time.perf_counter() - s)
    tps = {k: 8 * (n2 - n1) / (min(t2) - min(t1)) for k, (t1, t2) in times.items()}
    same_loop = bool(torch.equal(loops["dense"](n1), loops["paged"](n1)))
    per_step = {k: _kernels_per_step(torch, f, n1, n2) for k, f in loops.items()}
    paged["generate_b8_L2048"] = {"tokens_per_s": tps, "raw_s": times,
                                  "paged_over_dense": tps["paged"] / tps["dense"],
                                  "kernels_per_step": per_step,
                                  "tokens_equal": same_loop}
    log(f"[paged] B=8, L=2048 generate loop, grouped-int4 weights, int8 cache "
        f"(slope {n1}->{n2}, min of 3 interleaved rounds): paged (page {PAGE}) "
        f"{tps['paged']:.1f} tokens/s, dense {tps['dense']:.1f} tokens/s, ratio "
        f"{tps['paged'] / tps['dense']:.3f}; kernels a decode step: paged "
        f"{per_step['paged']:.1f}, dense {per_step['dense']:.1f}; tokens equal: "
        f"{same_loop}")
    if not same_loop:
        raise AssertionError("the paged generate loop's tokens differ from the dense loop's")

    # the paged kernel path against the plain path on the CPU, on f32 pools:
    # on int8 pools a last-ulp difference upstream can move a round-half
    # point of the quantize-on-write by a whole step (phase 3 compares on an
    # f32 cache for the same reason)
    cpu_model = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, qc, max_len=2048,
                                   device="cpu")
    interop.load_variables(cpu_model, _to_cpu(torch, variables))
    toks = torch.as_tensor(r.randint(0, VOCAB, size=(1, 16)))
    errs = []
    caches = {d: init_paged_cache(m, 1, page_size=PAGE)
              for d, m in (("cuda", model), ("cpu", cpu_model))}
    got, gc, idx = prefill(model, toks.to(dev), cache=caches["cuda"])
    want, cc, _ = prefill(cpu_model, toks, cache=caches["cpu"])
    tok = torch.argmax(want, -1).to(torch.int32)[:, None]
    with torch.no_grad():
        g2, _ = model(tok.to(dev), cache=gc, cache_index=idx)
        w2, _ = cpu_model(tok, cache=cc, cache_index=idx)
    for a, b_ in ((got, want), (g2[:, -1], w2[:, -1])):
        a = a.cpu()
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite logits")
        err = float((a - b_).abs().max())
        tol = 1e-4 * float(b_.abs().max())
        errs.append(err)
        log(f"[paged] logits vs plain CPU path (paged f32 cache, grouped int4): "
            f"max_abs_err {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError("paged kernel-path logits disagree with the plain path")
    paged["logits_err_vs_cpu"] = max(errs)


def _profile_generate(torch, model, prompt):
    from torch.profiler import ProfilerActivity, profile

    from jaxlsq_torch.serve import make_generate

    gen = make_generate(model, prompt.shape[1], N2, cache_dtype=torch.bfloat16)
    gen(prompt).cpu()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s = time.perf_counter()
        gen(prompt).cpu()
        wall = time.perf_counter() - s
    by_name = {}
    n_kernels = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # instances of one template share the truncated name: summed
            key = e.key[:60]
            by_name[key] = by_name.get(key, 0.0) + e.self_device_time_total / 1e3
            n_kernels += e.count
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall * 1e3, "device_ms": dev_ms,
            "busy_share": dev_ms / (wall * 1e3), "kernels_per_token": n_kernels / N2,
            "top": top[:12]}


def _to_cpu(torch, tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(torch, v) for k, v in tree.items()}
    return tree.to("cpu")


def phase_times(torch, rec):
    import torch.nn.functional as F

    from jaxlsq_torch.serve.attention import decode_attention, decode_attention_plain
    from jaxlsq_torch.serve.matmul import LAUNCHES as MM

    saved = dict(MM)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    times = {}
    rec["times"] = times
    for name in ("wo8", "wo4", "wo4g"):
        times[name] = [row for layer, (k, n) in WO_SHAPES.items()
                       for row in _time_wo(torch, name, layer, k, n, (1, 8, 256), g)]
        for m in (1, 8, 256):
            rows = [r for r in times[name] if r["M"] == m]
            log(f"[time] {name} M={m}, sum over the five d1024 shapes: "
                f"{sum(r['ms'] for r in rows) * 1e3:.2f} us on the device (bound "
                f"{sum(r['bound_ms'] for r in rows) * 1e3:.2f} us; torch.matmul "
                f"{sum(r['library_ms'] for r in rows) * 1e3:.2f} us)")
    # the int4 kernels at the lab's K = N = 8192 (phase 12 times wo4 there too)
    times["wo4g_k8192"] = _time_wo(torch, "wo4g", "k8192", LAB_K, LAB_N, (1,), g)

    hd = 64
    rows = []
    for carrier, b, length, t in (("int8", 8, 2048, 1), ("int4", 8, 2048, 1),
                                  ("bf16", 8, 2048, 1), ("bf16", 1, 240, 1),
                                  ("bf16", 8, 240, 1), ("bf16", 8, 240, 32),
                                  ("int8", 1, 8192, 1)):
        q = torch.randn(b, HEADS, t, hd, device=dev, generator=g)
        one = _rand_cache(torch, carrier, b, HEADS, length, hd, g)
        nbytes_cache = sum(x.numel() * x.element_size() for x in
                           (one if isinstance(one, tuple) else (one,)))
        reps = copies_for(2 * nbytes_cache)
        caches = [(_rand_cache(torch, carrier, b, HEADS, length, hd, g),
                   _rand_cache(torch, carrier, b, HEADS, length, hd, g))
                  for _ in range(reps)]
        idx = torch.full((b,), length - t, dtype=torch.int32, device=dev)  # all keys live
        ms, call = measure(lambda ck, cv: decode_attention(q, ck, cv, idx),
                           caches)
        plain, _ = measure(lambda ck, cv: decode_attention_plain(q, ck, cv, idx),
                           caches[:2], reps=10)

        def deq(e):
            if not isinstance(e, tuple):
                return e.to(torch.float32)
            d = e[0]
            if d.dtype == torch.uint8:
                lo = ((d.to(torch.int32) & 0xF) ^ 8) - 8
                hi = ((d.to(torch.int32) >> 4) ^ 8) - 8
                d = torch.stack([lo, hi], -1).reshape(*d.shape[:-1], 2 * d.shape[-1])
            return d.to(torch.float32) * e[1][..., None]

        fcaches = [(deq(ck), deq(cv)) for ck, cv in caches[:copies_for(
            2 * 4 * b * HEADS * length * hd)]]
        kpos = torch.arange(length, device=dev)
        mask = kpos[None, :] <= (length - t + torch.arange(t, device=dev))[:, None]
        lib, _ = measure(lambda k_, v_: F.scaled_dot_product_attention(
            q, k_, v_, attn_mask=mask), fcaches)
        keys = length  # every key is visible at idx = length - t
        per_key = nbytes_cache // length  # bytes of one position of k (b, heads)
        nbytes = 2 * per_key * keys + 2 * q.numel() * 4
        flops = 4 * b * HEADS * t * keys * hd
        b_ms, b_by = bound(nbytes, flops)
        rows.append({"carrier": carrier, "B": b, "L": length, "t": t, "ms": ms,
                     "call_ms": call, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes, "flops": flops})
        log(f"[time] decode_attention {carrier} B={b} L={length} t={t} (all keys "
            f"live): {ms * 1e3:.2f} us on the device, {call * 1e3:.2f} us a call (bound {b_ms * 1e3:.2f} us by {b_by}; plain "
            f"{plain * 1e3:.2f} us; SDPA on the f32 cache {lib * 1e3:.2f} us)")
    times["decode_attention"] = rows
    times["paged_attention"] = _time_paged(torch, g)
    MM.update(saved)


def wo_bound(name, nbytes, flops):
    """The least time of a ``wo*`` call: ``wo8`` and ``wo4`` three bf16
    tensor-core passes (x in three exact parts) or the bytes, ``wo4g`` f32
    on the CUDA cores or the bytes."""
    if name == "wo4g":
        return bound(nbytes, flops)
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, 3 * flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _time_wo(torch, name, layer, k, n, ms, g):
    """``wo_matmul`` ("wo8", "wo4" or "wo4g" at group GROUP) on a seeded
    (k, n) weight at each M in ``ms``: device and call time, bound
    (:func:`wo_bound`, beside the f32 CUDA-core bound), plain version and
    ``torch.matmul`` on the dequantized f32 weight."""
    from jaxlsq_torch.core.spec import QuantSpec
    from jaxlsq_torch.serve.matmul import wo_matmul, wo_matmul_plain
    from jaxlsq_torch.serve.pack import (dequantize_weight, quantize_weight,
                                         quantize_weight_grouped)

    dev = torch.device("cuda")
    bits = 8 if name == "wo8" else 4
    w = torch.randn(k, n, device=dev, generator=g) * k ** -0.5
    if name == "wo4g":
        p = quantize_weight_grouped(w, group_size=GROUP)
    else:
        spec = QuantSpec.weight_default(bits, per_channel=True, axis=1)
        p = quantize_weight(w, w.abs().amax(0) / spec.quant_max,
                            torch.zeros(n, device=dev), spec, bits=bits)
    wbytes = p.data.numel() + 4 * p.scale.numel() + 4 * p.zero_point.numel()
    packs = [p] + [dataclasses.replace(p, data=p.data.clone(), scale=p.scale.clone(),
                                       zero_point=p.zero_point.clone())
                   for _ in range(copies_for(wbytes) - 1)]
    wdq = [dequantize_weight(q) for q in packs[:copies_for(4 * k * n)]]
    rows = []
    for m in ms:
        x = torch.randn(m, k, device=dev, generator=g)
        t, call = measure(wo_matmul, [(x, q) for q in packs])
        plain, _ = measure(wo_matmul_plain, [(x, q) for q in packs], reps=20)
        lib, _ = measure(torch.matmul, [(x, wd) for wd in wdq])
        nbytes = 4 * m * k + wbytes + 4 * m * n
        b_ms, b_by = wo_bound(name, nbytes, 2 * m * k * n)
        f32_ms = bound(nbytes, 2 * m * k * n)[0]
        rows.append({"layer": layer, "M": m, "K": k, "N": n, "ms": t, "call_ms": call,
                     "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                     "bound_by": b_by, "bound_f32_cuda_cores_ms": f32_ms, "bytes": nbytes,
                     "flops": 2 * m * k * n})
        log(f"[time] {name} {layer} M={m} K={k} N={n}: {t * 1e3:.2f} us on the device, "
            f"{call * 1e3:.2f} us a call (bound {b_ms * 1e3:.2f} us by {b_by}, f32 CUDA "
            f"cores {f32_ms * 1e3:.2f} us; plain "
            f"{plain * 1e3:.2f} us; torch.matmul on the dequantized f32 weight "
            f"{lib * 1e3:.2f} us)")
    return rows


def _time_paged(torch, g):
    """The paged kernel against the dense kernel on the same contents (the
    gathered cache), int8, t = 1, every key live: B = 8, L = 2048 at page
    sizes 16, 128 and 1024, and B = 1, L = 8192 at page 128; each with its
    plain version and SDPA on the gathered f32 cache."""
    import torch.nn.functional as F

    from jaxlsq_torch.serve.attention import decode_attention
    from jaxlsq_torch.serve.paged import (_gather_dense, paged_attention,
                                          paged_attention_plain)

    hd, t = 64, 1
    dev = g.device
    rows = []
    for b, length, ps in ((8, 2048, 16), (8, 2048, 128), (8, 2048, 1024), (1, 8192, 128)):
        q = torch.randn(b, HEADS, t, hd, device=dev, generator=g)
        idx = torch.full((b,), length - t, dtype=torch.int32, device=dev)
        one = _rand_pool(torch, "int8", b, HEADS, length, hd, ps, g)
        nbytes_cache = b * HEADS * length * (hd + 4)  # int8 rows + f32 scales, K or V
        reps = copies_for(2 * nbytes_cache)
        layers = [one] + [_rand_pool(torch, "int8", b, HEADS, length, hd, ps, g)
                          for _ in range(reps - 1)]
        dense = [_gather_dense(x) for x in layers]
        # paged and dense in turns, twice: paged, dense, dense, paged
        pm1, pc = measure(lambda x: paged_attention(q, x, idx), [(x,) for x in layers])
        dm1, dc = measure(lambda c: decode_attention(q, c[0], c[1], idx),
                          [(c,) for c in dense])
        dm2, _ = measure(lambda c: decode_attention(q, c[0], c[1], idx),
                         [(c,) for c in dense])
        pm2, _ = measure(lambda x: paged_attention(q, x, idx), [(x,) for x in layers])
        plain, _ = measure(lambda x: paged_attention_plain(q, x, idx),
                           [(x,) for x in layers[:2]], reps=10)
        fcaches = [tuple(e[0].to(torch.float32) * e[1][..., None] for e in c)
                   for c in dense[:copies_for(2 * 4 * b * HEADS * length * hd)]]
        lib, _ = measure(lambda c: F.scaled_dot_product_attention(
            q, c[0], c[1]), [(c,) for c in fcaches])
        table_bytes = 4 * one.table.numel()
        nbytes = 2 * nbytes_cache + table_bytes + 2 * q.numel() * 4
        flops = 4 * b * HEADS * t * length * hd
        b_ms, b_by = bound(nbytes, flops)
        ms, dms = min(pm1, pm2), min(dm1, dm2)
        rows.append({"page_size": ps, "carrier": "int8", "B": b, "L": length, "t": t,
                     "ms": ms, "ms_runs": [pm1, pm2], "call_ms": pc,
                     "dense_ms": dms, "dense_ms_runs": [dm1, dm2], "dense_call_ms": dc,
                     "paged_over_dense": ms / dms, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
                     "bytes": nbytes, "flops": flops})
        log(f"[time] paged_attention int8 page {ps} B={b} L={length} t={t} (all keys "
            f"live): {pm1 * 1e3:.2f} / {pm2 * 1e3:.2f} us on the device, dense kernel on "
            f"the same contents {dm1 * 1e3:.2f} / {dm2 * 1e3:.2f} us (paged/dense "
            f"{ms / dms:.3f}); bound {b_ms * 1e3:.2f} us by {b_by}; plain "
            f"{plain * 1e3:.2f} us; SDPA on the f32 cache {lib * 1e3:.2f} us")
        del layers, dense, fcaches
    return rows


# ---------------------------------------------------------------------------
# the QAT training slice: the fake-quant kernels and resnet18_cifar's step
# ---------------------------------------------------------------------------

def _resnet(torch, device, seed):
    from jaxlsq_torch.models import default_qconfig, resnet18_cifar

    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=2)
    return resnet18_cifar(10, qc, device=device, seed=seed)


def _image_batches(torch, n, b, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [{"image": torch.randn(b, 3, 32, 32, device="cuda", generator=g),
             "label": torch.randint(0, 10, (b,), device="cuda", generator=g)}
            for _ in range(n)]


def _sgd(torch, model):
    return torch.optim.SGD(model.parameters(), lr=1e-2, momentum=0.9)


def _capture_step(torch):
    """One eager training step of a fresh resnet18_cifar at B = 64, with
    every quantizer's input, qparams and incoming gradient captured by
    hooks."""
    from jaxlsq_torch.models.layers import FakeQuantize
    from jaxlsq_torch.parallel import make_train_step

    model = _resnet(torch, "cuda", seed=1)
    caps = []

    def hook(name, mod, inputs, out):
        cap = {"name": name, "x": inputs[0].detach().clone(),
               "scale": mod.scale.detach().clone(),
               "shift": mod.shift.detach().clone(), "spec": mod.cfg.spec}
        caps.append(cap)
        out.register_hook(lambda g: cap.__setitem__("g", g.detach().clone()))

    handles = [mod.register_forward_hook(
        lambda m, i, o, name=name: hook(name, m, i, o))
        for name, mod in model.named_modules() if isinstance(mod, FakeQuantize)]
    batch = _image_batches(torch, 1, TRAIN_B, seed=11)[0]
    # in the observer window the stem's qparams take no gradient, so only
    # an image that does gives the stem's quantizer an incoming gradient
    batch["image"].requires_grad_(True)
    make_train_step(model, _sgd(torch, model), jit=False)(batch)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    if len(caps) != 42 or any("g" not in c for c in caps):
        raise AssertionError(f"captured {len(caps)} quantizers, expected 42 with gradients")
    return caps


def _fq_term_sums(torch, g, x, s, b, spec, init_mode, gs):
    """Per qparam, |gs| times the sum of |term| of dS and of dB, in f64: the
    scale of a difference in summation order."""
    from jaxlsq_torch.core.golden import broadcast_qparams

    x, g = x.double(), g.double()
    s = s.double().abs().clamp_min(2.0 ** -23)
    b = b.double()
    axis = spec.axis % x.dim() if spec.per_channel else None
    if axis is not None:
        s, b = (broadcast_qparams(t, x.dim(), axis) for t in (s, b))
    zp = torch.round(torch.clamp(-b / s, spec.type_min, spec.type_max))
    xq = torch.clamp(x / s + zp, spec.quant_min, spec.quant_max)
    inside = (spec.quant_min < xq) & (xq < spec.quant_max)
    xfq = (torch.round(xq) - zp) * s
    geff = 2 * (xfq - x) if init_mode else g
    ds = torch.where(inside, geff * (xfq - x) / s,
                     torch.where(xq <= spec.quant_min, geff * (spec.quant_min - zp),
                                 geff * (spec.quant_max - zp))).abs()
    db = torch.where(inside, 0.0, geff).abs()
    red = tuple(a for a in range(x.dim()) if a != axis)
    return ds.sum(dim=red) * abs(gs), db.sum(dim=red) * abs(gs)


def _same_bits(torch, got, want):
    """NaN where ``want`` has NaN, every other element bit-equal."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], want[~nan])


def _sum_err(torch, got, want, tot):
    """The finite sums' largest error and whether every sum passes: NaN and
    ±inf where ``want`` has them, a finite sum equal or within 1e-5 of its
    term sum (eval mode's zeros have a NaN term sum where a qparam is
    NaN)."""
    got, want = got.double().reshape(tot.shape), want.double().reshape(tot.shape)
    fin = torch.isfinite(want)
    odd = ~fin & ~torch.isnan(want)
    same = (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(got[odd], want[odd]))
    err = torch.where(fin, got - want, torch.zeros_like(want)).abs()
    ok = same and bool(((err == 0) | (err <= 1e-5 * tot) | ~fin).all())
    rel = torch.where(fin & (err > 0), err / tot.clamp_min(1e-30), torch.zeros_like(err))
    return ok, float(err.max()), float(rel.max())


def _check_fq(torch, x, s, b, g, spec, errs, what, traced=False):
    """The static kernels (train/eval/init modes) or their traced twins (the
    four flag pairs) against their plain versions on the card: forward and
    dX bit-exact (NaN where the plain has NaN), dS/dB within 1e-5 of their
    term sums (NaN and ±inf where the plain has them)."""
    from jaxlsq_torch.core.golden import (effective_grad_scale, golden_backward,
                                          golden_backward_traced, golden_forward,
                                          golden_forward_traced)
    from jaxlsq_torch.ops.fake_quant import (fake_quant_backward,
                                             fake_quant_backward_traced,
                                             fake_quant_forward,
                                             fake_quant_forward_traced,
                                             fake_quant_fwdbwd)

    kind = ("pc" if spec.per_channel else "pt") + ("_traced" if traced else "")
    gs = effective_grad_scale(spec, x.numel(), s.numel())
    worst = 0.0
    for ev, ini in (FLAG_PAIRS if traced else FLAG_PAIRS[:3]):
        eval_mode, init_mode = bool(ev), bool(ini)
        if traced:
            flags = torch.tensor([float(ev), float(ini)], device=x.device)
            out = fake_quant_forward_traced(x, s, b, flags, spec)
            dx, ds, db = fake_quant_backward_traced(g, x, s, b, flags, spec)
            ref = golden_forward_traced(x, s, b, spec, flags[0], flags[1])
            rdx, rds, rdb = golden_backward_traced(g, x, s, b, spec, flags[0],
                                                   flags[1])
        else:
            out = fake_quant_forward(x, s, b, spec, init_mode)
            dx, ds, db = fake_quant_backward(g, x, s, b, spec, eval_mode, init_mode)
            ref = golden_forward(x, s, b, spec, init_mode=init_mode)
            rdx, rds, rdb = golden_backward(g, x, s, b, spec, eval_mode=eval_mode,
                                            init_mode=init_mode)
        torch.cuda.synchronize()
        if not (_same_bits(torch, out, ref) and _same_bits(torch, dx, rdx)):
            raise AssertionError(
                f"{what}: fq {kind} forward/dX not bit-exact (eval={eval_mode}, "
                f"init={init_mode}): {float((out - ref).abs().nan_to_num(1.0).max())}, "
                f"{float((dx - rdx).abs().nan_to_num(1.0).max())}")
        tot_s, tot_b = _fq_term_sums(torch, g, x, s, b, spec, init_mode, gs)
        e_sums = 0.0
        for got, want, tot in ((ds, rds, tot_s), (db, rdb, tot_b)):
            ok, err, rel = _sum_err(torch, got, want, tot)
            if not ok:
                raise AssertionError(f"{what}: fq {kind} dS/dB off by {err} or not "
                                     f"NaN/inf where the plain is (eval={eval_mode}, "
                                     f"init={init_mode})")
            e_sums = max(e_sums, err)
            worst = max(worst, rel)
        errs[f"fq_fwd_{kind}"] = max(errs[f"fq_fwd_{kind}"], _bits_err(torch, out, ref))
        errs[f"fq_bwd_{kind}"] = max(errs[f"fq_bwd_{kind}"], _bits_err(torch, dx, rdx), e_sums)
        if traced or eval_mode or init_mode:
            continue
        # the fused kernel: the static pair's bits, hence the plain version's
        fused = fake_quant_fwdbwd(g, x, s, b, spec=spec)
        torch.cuda.synchronize()
        if not all(_same_bits(torch, a, w) for a, w in zip(fused, (out, dx, ds, db))):
            raise AssertionError(f"{what}: fq_fwdbwd_{kind} differs from fq_fwd_{kind} "
                                 f"+ fq_bwd_{kind}")
        name = f"fq_fwdbwd_{kind}"
        errs[name] = max(errs[name], _bits_err(torch, fused[0], ref),
                         _bits_err(torch, fused[1], rdx), e_sums)
    return worst


def _bits_err(torch, got, want):
    """The largest |got - want| over the elements where both are finite."""
    fin = torch.isfinite(got) & torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0


def _nan_case(torch, shape, spec, g):
    """x (normal, sd 1.5) with NaN, +inf and -inf spread over it, g, and
    qparams; per channel, channel 1's scale and channel 2's shift NaN."""
    n = math.prod(shape)
    c = shape[spec.axis] if spec.per_channel else 1
    s = 0.01 + 0.04 * torch.rand(c, device="cuda", generator=g)
    b = (torch.zeros(c, device="cuda") if spec.symmetric
         else 0.2 * torch.randn(c, device="cuda", generator=g))
    x = torch.randn(n, device="cuda", generator=g) * 1.5
    picks = torch.randperm(n, device="cuda", generator=g)[:3 * max(2, n // 64)]
    specials = torch.tensor([float("nan"), float("inf"), -float("inf")], device="cuda")
    x[picks] = specials[torch.arange(picks.numel(), device="cuda") % 3]
    if spec.per_channel:
        s[1], b[2] = float("nan"), float("nan")
    return x.view(shape), torch.randn(shape, device="cuda", generator=g), s, b


def phase_fq_kernels(torch, rec):
    from jaxlsq_torch.models import default_qconfig

    caps = _capture_step(torch)
    g = torch.Generator(device="cuda").manual_seed(2)
    errs = {k: 0.0 for k in FQ_KERNELS + TRACED_KERNELS + FUSED_KERNELS}
    shapes = []
    worst = {False: 0.0, True: 0.0}
    for c in caps:
        x, grad, spec = c["x"], c["g"], c["spec"]
        xr = torch.randn(x.shape, device="cuda", generator=g) * x.std() + x.mean()
        gr = torch.randn(x.shape, device="cuda", generator=g) * grad.std()
        for traced in (False, True):
            for xx, gg, data in ((x, grad, "real"), (xr, gr, "random")):
                worst[traced] = max(worst[traced], _check_fq(
                    torch, xx, c["scale"], c["shift"], gg, spec, errs,
                    f"{c['name']} {data}", traced))
        shapes.append({"name": c["name"], "shape": list(x.shape),
                       "per_channel": spec.per_channel, "numel": x.numel()})
    # one NaN/±inf tensor a kernel: an activation per tensor, a weight on
    # axis 0 (runs) and one on axis 1 (rows), NaN qparams per channel
    qc = default_qconfig(8, 8, per_channel_weights=True)
    nan_cases = (((64, 64, 8, 8), qc.activation.spec),
                 ((128, 64, 3, 3), qc.weight_for_axis(0).spec),
                 ((512, 1536), qc.weight_for_axis(1).spec))
    for shape, spec in nan_cases:
        x, grad, s, b = _nan_case(torch, shape, spec, g)
        for traced in (False, True):
            _check_fq(torch, x, s, b, grad, spec, errs, f"NaN/inf {shape}", traced)
    rec["max_abs_err"].update(errs)
    rec["fq_shapes"] = shapes
    rec["fq_worst_sum_rel_err"] = worst[False]
    rec["fq_traced_worst_sum_rel_err"] = worst[True]
    n_act = sum(r["numel"] for r in shapes if not r["per_channel"])
    n_w = sum(r["numel"] for r in shapes if r["per_channel"])
    log(f"[check] fake-quant kernels at the {len(shapes)} quantizer shapes of "
        f"resnet18_cifar, B={TRAIN_B} ({n_act} activation and {n_w} weight "
        "elements a step), real and random data, the static four in "
        "train/eval/init and the traced four at the four (eval, init) flag pairs, "
        "the fused two in train mode (bit-equal to the static pair), then each "
        f"on a NaN/inf tensor at {[list(sh) for sh, _ in nan_cases]} (NaN qparams "
        "per channel): forward and dX bit-exact (NaN where the plain has NaN); "
        f"dS/dB worst {worst[False]:.2e} (static) and {worst[True]:.2e} (traced) "
        "of their term sums (tol 1e-5; NaN and inf where the plain has them); "
        f"max_abs_err {errs}")


def _categorise(name):
    n = name.lower()
    if "fq_" in n:
        return "fake_quant"
    if "flash_" in n:
        return "flash_attention"
    if any(k in n for k in ("conv", "xmma", "gemm", "cudnn", "wgrad", "dgrad",
                            "implicit", "cutlass", "winograd", "fft", "complex",
                            "flip_filter", "nchw", "nhwc")):
        return "conv_matmul"
    if "multi_tensor_apply" in n:
        return "optimizer"
    return "other (norms, activations, observers, loss, grad zeroing)"


def _profile_train_step(torch, step, batch, step_ms):
    rows, span = device_profile(lambda: step(batch), "the train step",
                                sleep_ms=2 * step_ms + 5)
    by_name, by_cat, n_kernels = {}, {}, 0
    for e in rows:
        ms = e.self_device_time_total / 1e3
        by_name[e.key] = by_name.get(e.key, 0.0) + ms
        cat = _categorise(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        n_kernels += e.count
    dev_ms = sum(by_name.values())
    top = sorted(((k[:70], v) for k, v in by_name.items()), key=lambda kv: -kv[1])
    return {"device_ms": dev_ms, "span_ms": span, "busy_share": dev_ms / step_ms,
            "kernels": n_kernels, "by_category_ms": by_cat, "top": top[:15],
            "fq_kernels": {e.key: e.count for e in rows if "fq_" in e.key},
            "attention_kernels": {k: v for k, v in by_name.items()
                                  if _categorise(k) == "flash_attention"}}


def _batchnorm_ms(torch, shapes):
    """Device ms and kernels of the BatchNorm layers' forward and backward
    in training mode at ``shapes``, on fresh layers and random inputs."""
    from jaxlsq_torch.models import BatchNorm

    g = torch.Generator(device="cuda").manual_seed(6)
    layers = [(BatchNorm(shp[1], device="cuda"),
               torch.randn(shp, device="cuda", generator=g).requires_grad_(True),
               torch.randn(shp, device="cuda", generator=g)) for shp in shapes]

    def run():
        for bn, x, gy in layers:
            x.grad = None
            bn.zero_grad(set_to_none=True)
            bn(x).backward(gy)

    run()
    _, host_ms = events_ms(run)
    rows, span = device_profile(run, "the BatchNorm layers",
                                sleep_ms=3 * host_ms + 5)
    return {"ms": kernel_ms(rows), "span_ms": span,
            "kernels": sum(e.count for e in rows), "layers": len(shapes)}


def phase_train(torch, rec):
    from jaxlsq_torch.models import BatchNorm, QuantConv
    from jaxlsq_torch.parallel import make_train_step

    model = _resnet(torch, "cuda", seed=0)
    step = make_train_step(model, _sgd(torch, model), jit=False)
    batches = _image_batches(torch, TRAIN_STEPS + 1, TRAIN_B, seed=3)
    torch.cuda.synchronize()
    train = {}
    rec["train"] = train
    _, _, fq = reset_counts()
    losses, per_step = [], []
    t_start = None
    for i, batch in enumerate(batches[:TRAIN_STEPS]):
        if i == 2:  # steps 3-12: past the 2-batch observer window
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        before = dict(fq)
        losses.append(step(batch)["loss"])
        per_step.append({k: fq[k] - before[k] for k in FQ_KERNELS})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    timed = TRAIN_STEPS - 2
    bn_shapes, conv_flops = [], []
    hooks = [m.register_forward_hook(
        lambda mod, i, o: bn_shapes.append(tuple(i[0].shape)))
        for m in model.modules() if isinstance(m, BatchNorm)]
    # forward 2 * outputs * (I * kh * kw); dgrad and wgrad as much again each
    hooks += [m.register_forward_hook(
        lambda mod, i, o: conv_flops.append(3 * 2 * o.numel() * mod.kernel[0].numel()))
        for m in model.modules() if isinstance(m, QuantConv)]
    train.update({"steps_per_s": timed / wall, "images_per_s": timed * TRAIN_B / wall,
                  "step_ms": 1e3 * wall / timed})
    train["profile"] = _profile_train_step(torch, step, batches[TRAIN_STEPS],
                                           train["step_ms"])
    for h in hooks:
        h.remove()
    train["conv_gflop"] = sum(conv_flops) / 1e9
    train["launches"] = {k: fq[k] for k in FQ_KERNELS}
    losses = torch.stack(losses).cpu()
    train.update({"losses": losses.tolist(), "per_step_launches": per_step})
    p = train["profile"]
    log(f"[train] resnet18_cifar B={TRAIN_B}: losses "
        + " ".join(f"{v:.4f}" for v in train["losses"]))
    log(f"[train] steps 3-{TRAIN_STEPS}: {train['steps_per_s']:.2f} steps/s, "
        f"{train['images_per_s']:.1f} images/s ({train['step_ms']:.2f} ms a step)")
    log(f"[train] profiled step: kernels busy {p['device_ms']:.2f} ms "
        f"({100 * p['busy_share']:.1f}% of an unprofiled step; "
        f"{p['span_ms']:.2f} ms span when issued behind a sleep kernel), "
        f"{p['kernels']} kernels; by category: "
        + "; ".join(f"{k} {v:.2f} ms" for k, v in sorted(p["by_category_ms"].items(),
                                                         key=lambda kv: -kv[1])))
    log("[train] top kernels: " + "; ".join(f"{k} {v:.2f} ms" for k, v in p["top"][:8]))
    conv_ms = p["by_category_ms"].get("conv_matmul", 0.0)
    log(f"[train] convolutions: {train['conv_gflop']:.1f} GFLOP a step forward + "
        f"backward, {train['conv_gflop'] / max(conv_ms, 1e-9):.1f} TFLOP/s over their "
        f"{conv_ms:.2f} ms on the device (f32, TF32 off)")
    train["batchnorm"] = _batchnorm_ms(torch, bn_shapes)
    log(f"[train] the step's {len(bn_shapes)} BatchNorm layers alone, forward + "
        f"backward at their B={TRAIN_B} shapes: {train['batchnorm']['ms']:.2f} ms on "
        f"the device ({train['batchnorm']['span_ms']:.2f} ms span), "
        f"{train['batchnorm']['kernels']} kernels")
    log(f"[train] fake-quant launches on the path: {train['launches']}")
    fq_ms = p["by_category_ms"].get("fake_quant", 0.0)
    n_all = sum(r["numel"] for r in rec["fq_shapes"])
    b_ms, _ = bound(20 * n_all, 27 * n_all)
    train["fq_step"] = {"device_ms": fq_ms, "bound_ms": b_ms, "elements": n_all}
    log(f"[train] fake-quant kernels over the profiled step: {fq_ms:.3f} ms on the "
        f"device (bound {b_ms:.3f} ms for {n_all} elements at 8 + 12 bytes each)")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite training loss: {train['losses']}")
    for i, counts in enumerate(per_step):
        for k, v in counts.items():
            # in the observer window (steps 1-2) the stem's activation
            # quantizer reaches no parameter (its input is the image, its
            # qparams the observer's), so autograd runs no backward for it
            want = 20 if k == "fq_bwd_pt" and i < 2 else 21
            if v != want:
                raise AssertionError(f"step {i + 1}: {k} ran {v} times, not {want}")

    # one B = 8 step from the same state on the card and on the CPU plain path
    train["cpu_check"] = _cpu_check(
        torch, model, step, _image_batches(torch, 1, CHECK_B, seed=5)[0],
        lambda: _resnet(torch, "cpu", seed=0), f"[train] B={CHECK_B}")


def _act_quantizers(model):
    from jaxlsq_torch.models.layers import FakeQuantize

    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, FakeQuantize) and n.endswith("act_fq")]


def _cpu_check(torch, model, step, batch, cpu_model, label):
    """One training step from ``model``'s state on the card (``step``, on
    ``batch``) and on the CPU plain path (``cpu_model()``, a fresh CPU model
    of the same kind); the losses within 1e-3 relative.

    Matmuls and convolutions run their sums in another order on the two
    devices, so an activation can land on the other side of a rounding
    boundary and come out one quant step away; each such element moves every
    later layer a little and flips more of them.  So the CPU step takes the
    card's activation where the two differ by more than half a quant step,
    after checking that they differ by at most one step, and fails if more
    than ``MAX_MOVED_SHARE`` of the elements were taken: a kernel that rounds
    wrong on a share of its elements fails here.  The loss without that
    hand-over is recorded beside it."""
    from jaxlsq_torch import interop
    from jaxlsq_torch.parallel import make_train_step

    state = interop.qat_variables(model)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    card_out = {}
    hooks = [m.register_forward_hook(
        lambda mod, i, o, n=n: card_out.__setitem__(n, o.detach().cpu()))
        for n, m in _act_quantizers(model)]
    gpu_loss = float(step(batch)["loss"])
    for h in hooks:
        h.remove()

    def cpu_loss(hand_over):
        cm = cpu_model()
        interop.load_qat_variables(cm, state)
        moved = [0, 0]

        def take_card(n, mod, out):
            d = card_out[n] - out.detach()
            q = float(mod.scale.detach().abs().max())
            far = d.abs() > 0.5 * q
            if float(d.abs().max()) > q * (1 + 1e-5):
                raise AssertionError(f"{n}: card and CPU activations differ by "
                                     f"{float(d.abs().max())}, more than a quant step {q}")
            moved[0] += int(far.sum())
            moved[1] += out.numel()
            return out + torch.where(far, d, torch.zeros_like(d))

        if hand_over:
            for n, m in _act_quantizers(cm):
                m.register_forward_hook(lambda mod, i, o, n=n: take_card(n, mod, o))
        loss = float(make_train_step(cm, _sgd(torch, cm), jit=False)(cpu_batch)["loss"])
        return loss, moved

    free_loss, _ = cpu_loss(False)
    loss, (moved, total) = cpu_loss(True)
    rel = abs(gpu_loss - loss) / abs(loss)
    free_rel = abs(gpu_loss - free_loss) / abs(free_loss)
    log(f"{label} step from the same state: loss {gpu_loss:.6f} on the "
        f"card, {loss:.6f} on the CPU plain path (rel err {rel:.2e}, tol 1e-3) with "
        f"{moved} of {total} activation elements one quant step apart taken from "
        f"the card (at most {MAX_MOVED_SHARE:g} of them); without that hand-over "
        f"{free_loss:.6f} (rel err {free_rel:.2e})")
    if not moved <= MAX_MOVED_SHARE * total:
        raise AssertionError(f"{moved} of {total} activation elements differ by a quant "
                             "step between the card and the CPU plain path")
    if not rel <= 1e-3:
        raise AssertionError("the card's training loss disagrees with the CPU plain path")
    return {"gpu_loss": gpu_loss, "cpu_loss": loss, "rel_err": rel,
            "moved_elements": moved, "activation_elements": total,
            "cpu_loss_without_hand_over": free_loss, "rel_err_without_hand_over": free_rel}


def _graph_of(step):
    """The one CUDA graph a captured step holds, or None before its capture."""
    entries = [e for e in step.graphs.values() if e is not None]
    if len(entries) > 1:
        raise AssertionError(f"{len(entries)} captures for one batch shape")
    return entries[0][0] if entries else None


_FQ_NAME = re.compile(
    r"fq_(fwd|bwd_pt|bwd_pc|bwd_sum)(?:_pc)?(?:_runs|_rows)?_kernel"
    r"(?:<([^,>]*)(?:,\s*([^,>]*))?)?")
_TRUE = ("true", "(bool)1", "1")


def _fq_kinds(counts):
    """A profile's fake-quant kernel counts by kernel and regime (the
    ``kTraced`` template argument of csrc/fake_quant.cu; ``/fused`` where
    the backward's ``kOut`` is set; the per-channel forward counts as
    ``fwd``); an unknown name is kept whole."""
    out = {}
    for name, n in counts.items():
        m = _FQ_NAME.search(name)
        if m is None:
            key = name
        elif m.group(2) is None:
            key = m.group(1)
        else:
            key = m.group(1) + ("/traced" if m.group(2).strip() in _TRUE else "/static")
            if m.group(1) != "fwd" and m.group(3) is not None and m.group(3).strip() in _TRUE:
                key += "/fused"
        out[key] = out.get(key, 0) + n
    return out


def phase_train_captured(torch, rec):
    """Phase 6's leg through ``make_train_step(jit=True)``: one CUDA graph of
    the whole step, replayed across the observer window's end and a toggle."""
    from jaxlsq_torch.models import toggles
    from jaxlsq_torch.parallel import make_train_step

    model = _resnet(torch, "cuda", seed=0)
    step = make_train_step(model, _sgd(torch, model), jit=True)
    batches = _image_batches(torch, TRAIN_STEPS + 2, TRAIN_B, seed=3)
    acts = [m for _, m in _act_quantizers(model)]
    torch.cuda.synchronize()
    cap = {}
    rec["train_captured"] = cap
    _, _, fq = reset_counts()
    losses, per_step, graphs, phase = [], [], [], []
    t_start = None
    for i, batch in enumerate(batches[:TRAIN_STEPS]):
        if i == 2:  # steps 3-12: replays, the first one ends the observer window
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        before = dict(fq)
        losses.append(step(batch)["loss"])
        per_step.append({k: fq[k] - before[k] for k in FQ_KERNELS + TRACED_KERNELS})
        graphs.append(_graph_of(step))
        # the activation quantizers' counters and observer flags, kept on the card
        phase.append((torch.stack([m.current_batch for m in acts]),
                      torch.stack([m.observer_enabled for m in acts])))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    timed = TRAIN_STEPS - 2
    cap.update({"steps_per_s": timed / wall, "images_per_s": timed * TRAIN_B / wall,
                "step_ms": 1e3 * wall / timed,
                "launches": {k: fq[k] for k in TRACED_KERNELS},
                "per_step_launches": per_step,
                "losses": torch.stack(losses).cpu().tolist(),
                "act_current_batch": [p[0].cpu().tolist() for p in phase],
                "act_observer_enabled": [p[1].cpu().tolist() for p in phase]})
    log(f"[captured] resnet18_cifar B={TRAIN_B}, make_train_step(jit=True): losses "
        + " ".join(f"{v:.4f}" for v in cap["losses"]))
    log(f"[captured] steps 3-{TRAIN_STEPS} (graph replays): {cap['steps_per_s']:.2f} "
        f"steps/s, {cap['images_per_s']:.1f} images/s ({cap['step_ms']:.2f} ms a "
        f"step); the eager leg of phase 6 in this run: {rec['train']['step_ms']:.2f} "
        "ms a step")
    log(f"[captured] launches counted (warm-up + capture; a replay counts none): "
        f"{cap['launches']}; per step {per_step}")
    if not all(math.isfinite(v) for v in cap["losses"]):
        raise AssertionError(f"non-finite captured training loss: {cap['losses']}")
    for i, counts in enumerate(per_step):
        want = 21 if i < 2 else 0
        if any(counts[k] != want for k in TRACED_KERNELS) or any(
                counts[k] for k in FQ_KERNELS):
            raise AssertionError(f"captured step {i + 1}: launches {counts}, expected "
                                 f"{want} of each traced kernel and no static one")
    if (graphs[0] is not None or graphs[1] is None
            or any(g is not graphs[1] for g in graphs[1:])):
        raise AssertionError("the captured leg did not run one graph for steps 2-12")
    for i, (cb, on) in enumerate(zip(cap["act_current_batch"],
                                     cap["act_observer_enabled"])):
        k = i + 1  # the observer window is steps 1-2; step 3 switches to LSQ
        if set(cb) != {min(k, 3)} or set(on) != {k <= 2}:
            raise AssertionError(f"step {k}: activation counters {cb}, observer "
                                 f"flags {on}; the window switch went wrong")

    p = cap["profile"] = _profile_train_step(torch, step, batches[TRAIN_STEPS],
                                             cap["step_ms"])
    replay = cap["replay_fq_kernels"] = _fq_kinds(p["fq_kernels"])
    log(f"[captured] profiled replay: kernels busy {p['device_ms']:.2f} ms "
        f"({100 * p['busy_share']:.1f}% of an unprofiled replay's "
        f"{cap['step_ms']:.2f} ms; {p['span_ms']:.2f} ms span behind a sleep kernel), "
        f"{p['kernels']} kernels; by category: "
        + "; ".join(f"{k} {v:.2f} ms" for k, v in sorted(p["by_category_ms"].items(),
                                                         key=lambda kv: -kv[1])))
    log("[captured] top kernels: " + "; ".join(f"{k} {v:.2f} ms" for k, v in p["top"][:8]))
    log(f"[captured] fake-quant kernels in the replay: {replay}")
    # every backward is one kernel: a sum kernel (``bwd_sum`` by the name
    # pattern) would show here and fail the gate
    want = {"fwd/traced": 42, "bwd_pt/traced": 21, "bwd_pc/traced": 21}
    if replay != want:
        raise AssertionError(f"the replay ran fake-quant kernels {replay}, not {want}")

    # a toggle between two replays, honoured without a new capture
    def act_grads_nonzero():
        return sum(int(m.scale.grad.count_nonzero()) + int(m.shift.grad.count_nonzero())
                   for m in acts)

    nz_before = act_grads_nonzero()
    graph = _graph_of(step)
    toggles.disable_fake_quant_on_act(model)
    loss = float(step(batches[TRAIN_STEPS + 1])["loss"])
    nz_after = act_grads_nonzero()
    cap["toggle"] = {"act_qparam_grads_nonzero_before": nz_before,
                     "act_qparam_grads_nonzero_after": nz_after, "loss": loss}
    log(f"[captured] disable_fake_quant_on_act between two replays: nonzero "
        f"activation qparam gradients {nz_before} -> {nz_after}, loss {loss:.4f}, "
        "same graph")
    if not (nz_before > 0 and nz_after == 0 and math.isfinite(loss)
            and _graph_of(step) is graph and len(step.graphs) == 1
            and not any(bool(m.fake_quant_enabled) for m in acts)):
        raise AssertionError(f"the toggle was not honoured by the replay: {cap['toggle']}")


def _train_state(model, opt):
    """Every parameter and buffer of ``model`` and every tensor of the
    optimizer's state (SGD's momentum buffers; AdamW's moments and step)."""
    import torch

    state = {f"model/{k}": v for k, v in model.state_dict().items()}
    state.update({f"optim/{n}/{k}": v for n, p in model.named_parameters()
                  for k, v in opt.state[p].items() if torch.is_tensor(v)})
    return state


def _steps_equal(torch, models, opts, batches, toggle_at=None, schedule=None):
    """The eager (``models[0]``) and the captured (``models[1]``) step from one
    state over ``batches`` (act fake-quant toggled off before step
    ``toggle_at``; with ``schedule``, the lr set to ``schedule(i)`` before
    step i: the eager side fills its device lr, the captured side writes a
    Python float into ``group['lr']``): ``(leaves a step, losses, unequal
    leaves)``; a float leaf that is not bit-equal is recorded with its
    largest difference over its largest magnitude."""
    from jaxlsq_torch.models import toggles
    from jaxlsq_torch.parallel import make_train_step

    steps = [make_train_step(m, o, jit=jit)
             for m, o, jit in zip(models, opts, (False, True))]
    unequal, n_leaves, losses = [], 0, []
    for i, batch in enumerate(batches):
        if i + 1 == toggle_at:
            for m in models:
                toggles.disable_fake_quant_on_act(m)
        if schedule is not None:
            for group in opts[0].param_groups:
                group["lr"].fill_(schedule(i))
            for group in opts[1].param_groups:
                group["lr"] = schedule(i)
        pair = [s(batch)["loss"] for s in steps]
        losses.append([float(v) for v in pair])
        states = [{"loss": v, **_train_state(m, o)}
                  for v, m, o in zip(pair, models, opts)]
        n_leaves = len(states[0])
        for name, a in states[0].items():
            b = states[1][name]
            if torch.equal(a, b):
                continue
            rel = math.inf
            if a.is_floating_point() and a.shape == b.shape:
                rel = (float((a.double() - b.double()).abs().max())
                       / max(float(a.abs().max()), 1e-30))
            unequal.append({"step": i + 1, "leaf": name, "rel": rel})
    _graph_of(steps[1])  # one capture
    return n_leaves, losses, unequal


def _schedule(base):
    """A decaying lr that changes before every step."""
    return lambda i: base * (1.0 - 0.15 * i)


def phase_captured_vs_eager(torch, rec):
    """The eager and the captured step from one state, cuDNN deterministic:
    losses and every leaf equal over steps across the window's end and a
    toggle (a float leaf that is not may differ by 1e-6 of its largest
    magnitude, and is recorded); then the same under an lr that changes
    before every step, for SGD (momentum 0.9, weight decay 1e-2, fused=True)
    and AdamW (weight decay 1e-2, capturable=True) with a device lr on both
    sides: the weight decay reaches the quantizers' qparams across the
    window's end."""
    dev = torch.device("cuda")
    legs = (
        ("sgd", None, _sgd),
        ("sgd_fused_wd_schedule", _schedule(1e-2),
         lambda torch, m: torch.optim.SGD(m.parameters(), lr=torch.tensor(1e-2, device=dev),
                                          momentum=0.9, weight_decay=1e-2, fused=True)),
        ("adamw_capturable_wd_schedule", _schedule(1e-3),
         lambda torch, m: torch.optim.AdamW(m.parameters(),
                                            lr=torch.tensor(1e-3, device=dev),
                                            weight_decay=1e-2, capturable=True)))
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    out = rec["captured_vs_eager"] = {}
    try:
        for name, schedule, make_opt in legs:
            models = [_resnet(torch, "cuda", seed=0) for _ in range(2)]
            opts = [make_opt(torch, m) for m in models]
            n_leaves, losses, unequal = _steps_equal(
                torch, models, opts, _image_batches(torch, EQUAL_STEPS, TRAIN_B, seed=7),
                toggle_at=EQUAL_STEPS, schedule=schedule)
            lrs = [float(g["lr"]) for g in opts[1].param_groups]
            out[name] = {"steps": EQUAL_STEPS, "leaves": n_leaves, "losses": losses,
                         "unequal": unequal, "final_lr": lrs}
            log(f"[equal] {name}: eager vs captured step from one state, cuDNN "
                f"deterministic, {EQUAL_STEPS} steps (window end at 3, act fake-quant "
                f"off at {EQUAL_STEPS}): {n_leaves} leaves a step, {len(unequal)} not "
                f"bit-equal {unequal[:5]}; losses {losses}; captured lr at the end {lrs}")
            worst = max((u["rel"] for u in unequal), default=0.0)
            if not worst <= 1e-6:
                raise AssertionError(f"{name}: the captured step left another state "
                                     f"than the eager step: {unequal[:10]}")
            if schedule is not None and lrs != [float(torch.tensor(schedule(EQUAL_STEPS - 1)))]:
                raise AssertionError(f"{name}: the captured step's lr is {lrs}")
            del models, opts
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def phase_fq_times(torch, rec):
    from jaxlsq_torch.core.golden import (golden_backward, golden_backward_traced,
                                          golden_forward, golden_forward_traced)
    from jaxlsq_torch.models import default_qconfig
    from jaxlsq_torch.ops.fake_quant import (fake_quant_backward,
                                             fake_quant_backward_traced,
                                             fake_quant_forward,
                                             fake_quant_forward_traced)

    qc = default_qconfig(8, 8, per_channel_weights=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    times = rec["times"]
    # the table's shapes, then the LM head's (K, N) weight on axis 1 (its
    # records' names end in "_kn")
    for kind, shape, spec, tag in (
            ("pt", (64, 64, 32, 32), qc.activation.spec, ""),
            ("pc", (512, 512, 3, 3), qc.weight_for_axis(0).spec, ""),
            ("pc", (LM_DIM, LM_VOCAB), qc.weight_for_axis(1).spec, "_kn")):
        n = math.prod(shape)
        c = shape[spec.axis] if spec.per_channel else 1
        if spec.per_channel:  # weights ~ lecun-normal over the fan-in, symmetric
            sd = (n // c) ** -0.5
            s = torch.full((c,), 4 * sd / spec.quant_max, device=dev)
            b = torch.zeros(c, device=dev)
        else:  # unit activations over the 0..qmax range
            sd = 1.0
            s = torch.full((1,), 6.0 / spec.quant_max, device=dev)
            b = -s * (spec.quant_max // 2)
        zp = -b / s  # the library's float zero point for the same grid
        reps = copies_for(8 * n)
        xs = [torch.randn(shape, device=dev, generator=g) * sd for _ in range(reps)]
        gs_ = [torch.randn(shape, device=dev, generator=g) for _ in range(reps)]
        fwd_args = [(x,) for x in xs]
        bwd_args = list(zip(xs, gs_))
        if spec.per_channel:
            def lib_fwd(x):
                return torch._fake_quantize_learnable_per_channel_affine(
                    x, s, zp, spec.axis, spec.quant_min, spec.quant_max, 1.0)
        else:
            def lib_fwd(x):
                return torch._fake_quantize_learnable_per_tensor_affine(
                    x, s, zp, spec.quant_min, spec.quant_max, 1.0)
        s_l, zp_l = s.clone().requires_grad_(True), zp.clone().requires_grad_(True)
        leaves = [(x.clone().requires_grad_(True), gg) for x, gg in bwd_args]

        def lib_fwdbwd(x, gg):
            if spec.per_channel:
                y = torch._fake_quantize_learnable_per_channel_affine(
                    x, s_l, zp_l, spec.axis, spec.quant_min, spec.quant_max, 1.0)
            else:
                y = torch._fake_quantize_learnable_per_tensor_affine(
                    x, s_l, zp_l, spec.quant_min, spec.quant_max, 1.0)
            return torch.autograd.grad(y, (x, s_l, zp_l), gg)

        flags = torch.zeros(2, device=dev)  # the traced kernels in train mode
        for name, fn, plain_fn, lib_fn, args, lib_args, nbytes, ops in (
                (f"fq_fwd_{kind}", lambda x: fake_quant_forward(x, s, b, spec),
                 lambda x: golden_forward(x, s, b, spec), lib_fwd, fwd_args,
                 fwd_args, 8 * n, 7 * n),
                (f"fq_bwd_{kind}", lambda x, gg: fake_quant_backward(gg, x, s, b, spec),
                 lambda x, gg: golden_backward(gg, x, s, b, spec), lib_fwdbwd,
                 bwd_args, leaves, 12 * n, 20 * n),
                (f"fq_fwd_{kind}_traced",
                 lambda x: fake_quant_forward_traced(x, s, b, flags, spec),
                 lambda x: golden_forward_traced(x, s, b, spec, flags[0], flags[1]),
                 None, fwd_args, None, 8 * n, 7 * n),
                (f"fq_bwd_{kind}_traced",
                 lambda x, gg: fake_quant_backward_traced(gg, x, s, b, flags, spec),
                 lambda x, gg: golden_backward_traced(gg, x, s, b, spec, flags[0],
                                                      flags[1]),
                 None, bwd_args, None, 12 * n, 20 * n)):
            ms, call = measure(fn, args)
            plain, _ = measure(plain_fn, args, reps=20)
            if lib_fn is None:  # the same library call, timed above on these inputs
                static = times[name[:-len("_traced")] + tag]
                lib, lib_call = static["library_ms"], static["library_call_ms"]
            else:
                lib, lib_call = measure(lib_fn, lib_args)
            b_ms, b_by = bound(nbytes, ops)
            name += tag
            times[name] = {"shape": list(shape), "axis": spec.axis, "ms": ms, "call_ms": call,
                           "plain_ms": plain, "library_ms": lib,
                           "library_call_ms": lib_call, "bound_ms": b_ms,
                           "bound_by": b_by, "bytes": nbytes, "ops": ops}
            lib_what = ("torch._fake_quantize_learnable_per_"
                        + ("channel" if spec.per_channel else "tensor") + "_affine"
                        + (" forward" if "fwd" in name else " forward + backward"))
            log(f"[time] {name} {tuple(shape)}: {ms * 1e3:.2f} us on the device, "
                f"{call * 1e3:.2f} us a call (bound {b_ms * 1e3:.2f} us by {b_by}; "
                f"plain {plain * 1e3:.2f} us; {lib_what} {lib * 1e3:.2f} us on the "
                f"device, {lib_call * 1e3:.2f} us a call)")
        del xs, gs_, leaves, fwd_args, bwd_args


# ---------------------------------------------------------------------------
# long-context LSQ QAT of the transformer LM: the flash-attention kernels
# ---------------------------------------------------------------------------

def _flash_flops(b, h, t, hd):
    """Multiply-add operations (x2) that each flash function needs at these
    shapes, counting the causal triangle's t (t + 1) / 2 (query, key) pairs:
    the forward needs two products a pair (S, PV), the backward, given lse
    and D, five (S, dP, dV, dK, dQ)."""
    pairs = b * h * t * (t + 1) // 2
    return {"flash_fwd": 2 * 2 * hd * pairs, "flash_bwd": 5 * 2 * hd * pairs}


def _flash_flops_executed(b, h, t, hd):
    """The operations the kernels execute: the backward recomputes S and dP
    in both of its block roles, seven products a pair (4 + 3)."""
    pairs = b * h * t * (t + 1) // 2
    return {"flash_fwd": 2 * 2 * hd * pairs, "flash_bwd": (4 + 3) * 2 * hd * pairs}


def _flash_bytes(b, h, t, hd):
    """Each input read once and each output written once (f32)."""
    mat, row = 4 * b * h * t * hd, 4 * b * h * t
    return {"flash_fwd": 3 * mat + mat + row,             # q, k, v -> out, lse
            "flash_bwd": 4 * mat + 2 * row + 3 * mat}     # q, k, v, dO, lse, D -> dq, dk, dv


def tc_bound(nbytes, flops):
    """The least time of a 3xTF32 kernel: three TF32 tensor-core passes a
    product (f32-class accuracy), or the bytes."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, 3 * flops / TF32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _flash_case(torch, b, h, t, hd, g):
    q, k, v, do = (torch.randn(b, h, t, hd, device="cuda", generator=g) for _ in range(4))
    return q, k, v, do, hd ** -0.5


def phase_flash_kernels(torch, rec):
    """The two flash kernels against their plain versions on the same
    inputs: out and lse within 2e-5 of max|ref|, dQ, dK, dV within 1e-4 of
    max|ref| (the backward kernel gets the plain forward's lse and D); the
    backward's dq, dk, dv bit-equal across two runs."""
    from jaxlsq_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(8)
    errs = {k: 0.0 for k in FLASH_KERNELS}
    for b, h, t, hd in FLASH_SHAPES:
        q, k, v, do, sm = _flash_case(torch, b, h, t, hd, g)
        out, lse = fa.flash_fwd(q, k, v, sm)
        rout, rlse = fa.flash_fwd_plain(q, k, v, sm)
        d = (do * rout).sum(-1)
        dq, dk, dv = fa.flash_bwd(q, k, v, do, rlse, d, sm)
        again = fa.flash_bwd(q, k, v, do, rlse, d, sm)
        rdq, rdk, rdv = fa.flash_bwd_plain(q, k, v, do, rlse, d, sm)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b_) for a, b_ in zip((dq, dk, dv), again)):
            raise AssertionError(f"flash_bwd gave other bits on a second run at "
                                 f"{(b, h, t, hd)}")
        line = []
        for name, got, want, tol in (("flash_fwd", out, rout, 2e-5),
                                     ("flash_fwd", lse, rlse, 2e-5),
                                     ("flash_bwd", dq, rdq, 1e-4),
                                     ("flash_bwd", dk, rdk, 1e-4),
                                     ("flash_bwd", dv, rdv, 1e-4)):
            err = float((got - want).abs().max())
            lim = tol * float(want.abs().max())
            line.append(f"{err:.2e}/{lim:.2e}")
            if not err <= lim:
                raise AssertionError(f"{name} disagrees with its plain version at "
                                     f"{(b, h, t, hd)}: {err} > {lim}")
            errs[name] = max(errs[name], err)
        log(f"[check] flash kernels B={b} H={h} t={t} hd={hd}: max_abs_err/tol "
            f"out {line[0]}, lse {line[1]}, dq {line[2]}, dk {line[3]}, dv {line[4]}; "
            "backward bit-equal on a second run")
        del q, k, v, do, out, rout, dk, rdk, dv, rdv, dq, rdq, again
    rec["max_abs_err"].update(errs)


def _lm_qat(torch, device, impl, seed=0, window=None):
    """The flash_train_tpu.json LM: d512, depth 2, 8 heads, vocab 8192, rope,
    W8A8 QAT with per-channel weights and a two-batch observer window."""
    from jaxlsq_torch.models import QuantTransformerLM, default_qconfig

    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=2)
    return QuantTransformerLM(LM_VOCAB, LM_DIM, LM_DEPTH, LM_HEADS, qc,
                              max_len=LM_MAX, pos_embedding="rope",
                              train_attn_impl=impl, attn_window=window,
                              device=device, seed=seed)


def _token_batches(torch, n, b, t, seed):
    """Seeded token rows, the labels shifted by one."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n):
        x = torch.randint(0, LM_VOCAB, (b, t + 1), device="cuda", generator=g)
        out.append({"input": x[:, :-1].contiguous(), "label": x[:, 1:].contiguous()})
    return out


def phase_lm_fq_kernels(torch, rec):
    """The fake-quant kernels at the LM's quantizer shapes: every quantizer's
    input, qparams and incoming gradient from one eager step of the
    full-width 'flash' LM at B = 2, t = 4096, on that data and on random data
    of its spread; the static kernels and their traced twins as in phase 2."""
    from jaxlsq_torch.models.layers import FakeQuantize
    from jaxlsq_torch.parallel import make_train_step

    model = _lm_qat(torch, "cuda", "flash", seed=1)
    caps = []

    def hook(name, mod, inputs, out):
        cap = {"name": name, "x": inputs[0].detach().clone(),
               "scale": mod.scale.detach().clone(),
               "shift": mod.shift.detach().clone(), "spec": mod.cfg.spec}
        caps.append(cap)
        out.register_hook(lambda g: cap.__setitem__("g", g.detach().clone()))

    handles = [mod.register_forward_hook(lambda m, i, o, name=name: hook(name, m, i, o))
               for name, mod in model.named_modules() if isinstance(mod, FakeQuantize)]
    make_train_step(model, _sgd(torch, model), jit=False)(
        _token_batches(torch, 1, *LM_LEGS[0], seed=12)[0])
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    n_fq = 1 + 8 * LM_DEPTH + 2  # the table, 4 dense layers a block, lm_head
    if len(caps) != n_fq or any("g" not in c for c in caps):
        raise AssertionError(f"captured {len(caps)} quantizers, expected {n_fq} with gradients")
    del model
    g = torch.Generator(device="cuda").manual_seed(13)
    errs = {k: 0.0 for k in FQ_KERNELS + TRACED_KERNELS + FUSED_KERNELS}
    worst = {False: 0.0, True: 0.0}
    shapes = []
    for c in caps:
        x, grad, spec = c["x"], c["g"], c["spec"]
        xr = torch.randn(x.shape, device="cuda", generator=g) * x.std() + x.mean()
        gr = torch.randn(x.shape, device="cuda", generator=g) * grad.std()
        for traced in (False, True):
            for xx, gg, data in ((x, grad, "real"), (xr, gr, "random")):
                worst[traced] = max(worst[traced], _check_fq(
                    torch, xx, c["scale"], c["shift"], gg, spec, errs,
                    f"LM {c['name']} {data}", traced))
        shapes.append({"name": c["name"], "shape": list(x.shape),
                       "per_channel": spec.per_channel})
    for k, v in errs.items():
        rec["max_abs_err"][k] = max(rec["max_abs_err"][k], v)
    rec["lm_fq_shapes"] = shapes
    log(f"[check] fake-quant kernels at the {len(shapes)} quantizer shapes of the "
        f"d{LM_DIM} LM at B={LM_LEGS[0][0]}, t={LM_LEGS[0][1]} "
        f"({sorted({tuple(r['shape']) for r in shapes})}), real and random data, "
        "static, traced and fused: forward and dX bit-exact; dS/dB worst "
        f"{worst[False]:.2e} (static) and {worst[True]:.2e} (traced) of their term "
        "sums (tol 1e-5)")


def _lm_leg(torch, impl, b, t, jit, profile=False):
    """``LM_STEPS`` steps of a fresh LM: tokens/s over steps 3-8 (past the
    observer window; for ``jit`` the replays), the leg's own peak of
    allocated memory (model, optimizer, batches and steps; what earlier legs
    keep alive is subtracted), the flash launches of each step (gated), and
    with ``profile`` one more step profiled."""
    from jaxlsq_torch.ops.flash_attention import LAUNCHES as FA
    from jaxlsq_torch.parallel import make_train_step

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # what earlier legs keep alive
    torch.cuda.reset_peak_memory_stats()
    model = _lm_qat(torch, "cuda", impl)
    step = make_train_step(model, _sgd(torch, model), jit=jit)
    batches = _token_batches(torch, LM_STEPS + 1, b, t, seed=21)
    losses, per_step = [], []
    for i, batch in enumerate(batches[:LM_STEPS]):
        if i == 2:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        before = dict(FA)
        losses.append(step(batch)["loss"])
        per_step.append({k: FA[k] - before[k] for k in FA})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    timed = LM_STEPS - 2
    leg = {"impl": impl, "B": b, "t": t, "jit": jit,
           "tokens_per_s": timed * b * t / wall, "step_ms": 1e3 * wall / timed,
           "peak_allocated_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
           "losses": torch.stack(losses).cpu().tolist(), "per_step_launches": per_step}
    log(f"[lm] {impl} {'captured' if jit else 'eager'} B={b} t={t}: "
        f"{leg['tokens_per_s']:.0f} tokens/s ({leg['step_ms']:.2f} ms a step, steps "
        f"3-{LM_STEPS}), peak allocated {leg['peak_allocated_gib']:.3f} GiB; losses "
        + " ".join(f"{v:.4f}" for v in leg["losses"]))
    if not all(math.isfinite(v) for v in leg["losses"]):
        raise AssertionError(f"non-finite LM training loss: {leg['losses']}")
    for i, counts in enumerate(per_step):
        want = LM_DEPTH if impl == "flash" and (not jit or i < 2) else 0
        if any(v != want for v in counts.values()):
            raise AssertionError(f"{impl} step {i + 1} (jit={jit}): flash launches "
                                 f"{counts}, expected {want} of each")
    if jit and _graph_of(step) is None:
        raise AssertionError("the captured LM leg holds no graph")
    if profile:
        leg["profile"] = _profile_train_step(torch, step, batches[LM_STEPS],
                                             leg["step_ms"])
        p = leg["profile"]
        log(f"[lm] profiled {impl} {'replay' if jit else 'eager step'} B={b} t={t}: "
            f"kernels busy {p['device_ms']:.2f} ms ({100 * p['busy_share']:.1f}% of "
            f"{leg['step_ms']:.2f} ms), {p['kernels']} kernels; by category: "
            + "; ".join(f"{k} {v:.2f} ms" for k, v in sorted(
                p["by_category_ms"].items(), key=lambda kv: -kv[1]))
            + "; top: " + "; ".join(f"{k} {v:.2f} ms" for k, v in p["top"][:6]))
        log(f"[lm] attention kernels of that step: " + "; ".join(
            f"{k} {v:.3f} ms" for k, v in sorted(p["attention_kernels"].items())))
    return leg, model, step


def phase_lm(torch, rec):
    """The slice's main path: LSQ QAT of the full-width LM under 'flash' and
    'xla', eager and captured, at B = 2, t = 4096 and B = 4, t = 2048 (8192
    tokens a step), with every launch count reset before it and read after
    it; then the card-vs-CPU step, eager = captured, the window's routing and
    train-then-serve."""
    from jaxlsq_torch.ops.flash_attention import LAUNCHES as FA

    lm = rec["lm"] = {"legs": []}
    reset_counts()
    t_main = time.time()
    keep = None
    for b, t in LM_LEGS:
        for impl in ("flash", "xla"):
            for jit in (False, True):
                prof = (b, t) == LM_LEGS[0] and impl == "flash"
                leg, model, step = _lm_leg(torch, impl, b, t, jit, profile=prof)
                lm["legs"].append(leg)
                if prof and not jit:
                    keep = (model, step)
                del model, step
                torch.cuda.empty_cache()
    torch.cuda.synchronize()
    lm["wall_s"] = time.time() - t_main
    lm["launches"] = dict(FA)
    log(f"[lm] flash launches on the LM path: {lm['launches']}")
    for k, v in lm["launches"].items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was never launched on the LM path")
    peak = {(x["impl"], x["t"], x["jit"]): x["peak_allocated_gib"] for x in lm["legs"]}
    lm["xla_over_flash_peak"] = {f"t{t}": peak[("xla", t, False)] / peak[("flash", t, False)]
                                 for _, t in LM_LEGS}
    log(f"[lm] peak allocated, eager legs, xla / flash: {lm['xla_over_flash_peak']}")

    model, step = keep
    lm["cpu_check"] = _cpu_check(
        torch, model, step, _token_batches(torch, 1, 1, 512, seed=22)[0],
        lambda: _lm_qat(torch, "cpu", "flash"), "[lm] B=1, t=512")
    lm["equal"] = _lm_equal(torch)
    lm["window"] = _lm_window(torch)
    lm["serve"] = _lm_serve(torch, model)


def _lm_equal(torch):
    """3 eager and 3 captured 'flash' steps of the full-width LM from one
    state at B = 2, t = 4096, across the observer window: equal leaf by
    leaf."""
    from jaxlsq_torch import interop

    models = [_lm_qat(torch, "cuda", "flash", seed=3) for _ in range(2)]
    interop.load_qat_variables(models[1], interop.qat_variables(models[0]))
    opts = [_sgd(torch, m) for m in models]
    n_leaves, losses, unequal = _steps_equal(
        torch, models, opts, _token_batches(torch, 3, *LM_LEGS[0], seed=23))
    log(f"[lm] eager vs captured 'flash' steps from one state, B={LM_LEGS[0][0]} "
        f"t={LM_LEGS[0][1]}, 3 steps (window end at 3): {n_leaves} leaves a step, "
        f"{len(unequal)} not bit-equal {unequal[:5]}; losses {losses}")
    if unequal:
        raise AssertionError(f"the captured LM step left another state than the "
                             f"eager step: {unequal[:10]}")
    return {"leaves": n_leaves, "losses": losses}


def _lm_window(torch):
    """'flash' with a 512-key window (< t) takes the banded path: one eager
    step at B = 2, t = 4096 launches no flash kernel."""
    from jaxlsq_torch.ops.flash_attention import LAUNCHES as FA
    from jaxlsq_torch.parallel import make_train_step

    model = _lm_qat(torch, "cuda", "flash", window=512)
    before = dict(FA)
    loss = float(make_train_step(model, _sgd(torch, model), jit=False)(
        _token_batches(torch, 1, *LM_LEGS[0], seed=24)[0])["loss"])
    launched = {k: FA[k] - before[k] for k in FA}
    log(f"[lm] attn_window=512 under 'flash', B={LM_LEGS[0][0]} t={LM_LEGS[0][1]}: "
        f"loss {loss:.4f}, flash launches {launched} (the banded path)")
    if not (math.isfinite(loss) and not any(launched.values())):
        raise AssertionError(f"the windowed step ran flash kernels or diverged: "
                             f"{launched}, {loss}")
    return {"loss": loss, "flash_launches": launched}


def _lm_serve(torch, model):
    """Train-then-serve: the trained LM's variables (``qat_variables``) into
    a serve-mode LM (``load_variables`` converts them: int8 per-channel
    kernels, int8 table), ``make_generate`` at B = 1, and the prefill and
    one decode step's logits within 1e-4 of max|ref| of the CPU plain path;
    ``wo8`` and ``decode_attention`` must have launched."""
    import numpy as np

    from jaxlsq_torch import interop
    from jaxlsq_torch.models import QuantTransformerLM
    from jaxlsq_torch.serve import make_generate, prefill

    tree = interop.qat_variables(model)
    qc = model.qconfig.for_serving("none")
    served = {}
    for dev in ("cuda", "cpu"):
        served[dev] = QuantTransformerLM(LM_VOCAB, LM_DIM, LM_DEPTH, LM_HEADS, qc,
                                         max_len=T0 + N2, pos_embedding="rope",
                                         device=dev)
        interop.load_variables(served[dev], tree)
    mm, attn, _ = reset_counts()
    r = np.random.RandomState(9)
    prompt = torch.as_tensor(r.randint(0, LM_VOCAB, size=(1, T0)), device="cuda")
    toks = make_generate(served["cuda"], T0, 64)(prompt).cpu().numpy()
    if toks.shape != (1, 64) or not ((toks >= 0) & (toks < LM_VOCAB)).all():
        raise AssertionError(f"train-then-serve: bad tokens {toks.shape}")
    short = torch.as_tensor(r.randint(0, LM_VOCAB, size=(1, 16)))
    got, cache, idx = prefill(served["cuda"], short.to("cuda"))
    want, ccache, _ = prefill(served["cpu"], short)
    tok = torch.argmax(want, -1).to(torch.int32)[:, None]
    with torch.no_grad():
        g2, _ = served["cuda"](tok.to("cuda"), cache=cache, cache_index=idx)
        w2, _ = served["cpu"](tok, cache=ccache, cache_index=idx)
    errs = []
    for a, b_ in ((got, want), (g2[:, -1], w2[:, -1])):
        a = a.cpu()
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite served logits")
        errs.append(float((a - b_).abs().max()))
        tol = 1e-4 * float(b_.abs().max())
        if not errs[-1] <= tol:
            raise AssertionError(f"served logits disagree with the CPU plain path: "
                                 f"{errs[-1]} > {tol}")
    launches = {"wo8": mm["wo8"], "decode_attention": attn["decode_attention"]}
    log(f"[lm] train-then-serve: the trained LM converted (int8 per-channel) and "
        f"served, make_generate B=1 gave 64 tokens; prefill / decode logits vs the "
        f"CPU plain path max_abs_err {errs[0]:.3e} / {errs[1]:.3e} (tol 1e-4 of "
        f"max|ref|); launches {launches}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"the served LM did not run wo8 and decode_attention: "
                             f"{launches}")
    return {"logits_err_vs_cpu": errs, "launches": launches}


def phase_flash_times(torch, rec):
    """Each flash kernel at the LM's two attention shapes, beside its bounds
    (3xTF32 on the tensor cores, f32 on the CUDA cores), its plain version
    and SDPA (the PyTorch library call, timed here only): its forward, its
    backward alone (``autograd.grad`` of an output whose forward ran before
    the timed region) and forward + backward; SDPA's kernels are named from
    a profile of one forward + backward."""
    import torch.nn.functional as F

    from jaxlsq_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(14)
    rows = []
    for b, h, t, hd in FLASH_SHAPES[:2]:
        q, k, v, do, sm = _flash_case(torch, b, h, t, hd, g)
        sets = [(q, k, v, do)] + [tuple(x.clone() for x in (q, k, v, do))
                                  for _ in range(copies_for(16 * q.numel()) - 1)]
        out, lse = fa.flash_fwd(q, k, v, sm)
        d = (do * out).sum(-1)
        fns = {"flash_fwd": (lambda q_, k_, v_, do_: fa.flash_fwd(q_, k_, v_, sm),
                             lambda q_, k_, v_, do_: fa.flash_fwd_plain(q_, k_, v_, sm)),
               "flash_bwd": (
                   lambda q_, k_, v_, do_: fa.flash_bwd(q_, k_, v_, do_, lse, d, sm),
                   lambda q_, k_, v_, do_: fa.flash_bwd_plain(q_, k_, v_, do_, lse, d, sm))}
        leaves = [tuple(x.clone().requires_grad_(True) for x in s_[:3]) + (s_[3],)
                  for s_ in sets]

        def sdpa(q_, k_, v_, do_):
            return F.scaled_dot_product_attention(q_, k_, v_, is_causal=True, scale=sm)

        def sdpa_fwdbwd(q_, k_, v_, do_):
            return torch.autograd.grad(sdpa(q_, k_, v_, do_), (q_, k_, v_), do_)

        def sdpa_bwd(o_, q_, k_, v_, do_):
            return torch.autograd.grad(o_, (q_, k_, v_), do_, retain_graph=True)

        lib_fwd, _ = measure(sdpa, sets, reps=20)
        lib_fb, _ = measure(sdpa_fwdbwd, leaves, reps=20)
        outs = [(sdpa(*l_),) + l_ for l_ in leaves]
        lib_bwd, _ = measure(sdpa_bwd, outs, reps=20)
        del outs
        # SDPA's kernels named from a profile of one forward + backward; no
        # time is taken from it, and it is not held against the span: the
        # profiler on the card recorded none of SDPA's f32 forward kernels
        prof, _ = profiled(lambda: sdpa_fwdbwd(*leaves[0]), sleep_ms=2 * lib_fb + 5)
        sdpa_kernels = {e.key: e.self_device_time_total / 1e3 for e in prof}
        flops, nbytes = _flash_flops(b, h, t, hd), _flash_bytes(b, h, t, hd)
        executed = _flash_flops_executed(b, h, t, hd)
        row = {"B": b, "H": h, "t": t, "hd": hd, "sdpa_fwd_ms": lib_fwd,
               "sdpa_bwd_ms": lib_bwd, "sdpa_fwd_bwd_ms": lib_fb,
               "sdpa_kernels": sdpa_kernels}
        for name, (fn, plain_fn) in fns.items():
            ms, call = measure(fn, sets, reps=20)
            plain, _ = measure(plain_fn, sets[:2], reps=4)
            b_ms, b_by = tc_bound(nbytes[name], flops[name])
            cc_ms, _ = bound(nbytes[name], flops[name])
            row[name] = {"ms": ms, "call_ms": call, "plain_ms": plain, "bound_ms": b_ms,
                         "bound_by": b_by, "bound_f32_cuda_cores_ms": cc_ms,
                         "flops": flops[name], "flops_executed": executed[name],
                         "bytes": nbytes[name], "tflops": flops[name] / ms / 1e9,
                         "tflops_executed": executed[name] / ms / 1e9}
            log(f"[time] {name} B={b} H={h} t={t} hd={hd}: {ms:.3f} ms on the device, "
                f"{call:.3f} ms a call ({row[name]['tflops']:.2f} TFLOP/s of the products "
                f"the function needs, {row[name]['tflops_executed']:.2f} TFLOP/s of those "
                f"executed, f32-accurate; bound {b_ms:.3f} ms by {b_by} at 3xTF32 on the "
                f"tensor cores, {cc_ms:.3f} ms at f32 on the CUDA cores; plain {plain:.3f} ms)")
        row["kernels_fwd_bwd_ms"] = sum(row[k]["ms"] for k in FLASH_KERNELS)
        log(f"[time] SDPA (f32, causal) B={b} H={h} t={t} hd={hd}: forward "
            f"{lib_fwd:.3f} ms, backward alone {lib_bwd:.3f} ms, forward + backward "
            f"{lib_fb:.3f} ms; the kernels: forward {row['flash_fwd']['ms']:.3f} ms, "
            f"backward {row['flash_bwd']['ms']:.3f} ms, forward + backward "
            f"{row['kernels_fwd_bwd_ms']:.3f} ms")
        log("[time] SDPA's kernels as the profiler recorded them (one forward + "
            "backward): " + "; ".join(
            f"{k[:90]} {v:.3f} ms" for k, v in sorted(sdpa_kernels.items(),
                                                      key=lambda kv: -kv[1])))
        rows.append(row)
        del sets, leaves, q, k, v, do, out, lse, d
    rec["times"]["flash"] = rows


# ---------------------------------------------------------------------------
# jaxlsq's headline fwd+bwd chain (the fused kernel #5) and the int4 lab (#14)
# ---------------------------------------------------------------------------

def _chain_specs():
    from jaxlsq_torch.core.spec import QuantSpec
    from jaxlsq_torch.models import default_qconfig

    return {"pt": (QuantSpec(quant_min=0, quant_max=255), CHAIN_SHAPE),
            "pc": (default_qconfig(8, 8, per_channel_weights=True).weight_for_axis(0).spec,
                   CHAIN_PC_SHAPE)}


def _chain_legs(torch, spec):
    """One fwd+bwd of each leg: ``(y, g, s, b) -> (out, dX, dS, dB)``."""
    from jaxlsq_torch.core.golden import golden_backward, golden_forward
    from jaxlsq_torch.ops import fake_quant, fake_quant_fwdbwd

    def split(y, g, s, b):  # autograd: fq_fwd_* then fq_bwd_*
        y = y.detach().requires_grad_(True)
        s, b = s.detach().requires_grad_(True), b.detach().requires_grad_(True)
        out = fake_quant(y, s, b, spec)
        return (out.detach(), *torch.autograd.grad(out, (y, s, b), g))

    def fused(y, g, s, b):
        return fake_quant_fwdbwd(g, y, s, b, spec=spec)

    def plain(y, g, s, b):
        return (golden_forward(y, s, b, spec), *golden_backward(g, y, s, b, spec))

    def library(y, g, s, zp):  # its own float zero point in the shift's slot
        y = y.detach().requires_grad_(True)
        s, zp = s.detach().requires_grad_(True), zp.detach().requires_grad_(True)
        if spec.per_channel:
            out = torch._fake_quantize_learnable_per_channel_affine(
                y, s, zp, spec.axis, spec.quant_min, spec.quant_max, 1.0)
        else:
            out = torch._fake_quantize_learnable_per_tensor_affine(
                y, s, zp, spec.quant_min, spec.quant_max, 1.0)
        return (out.detach(), *torch.autograd.grad(out, (y, s, zp), g))

    return {"split": split, "fused": fused, "plain": plain, "library": library}


def _chain(fn, x, g, s0, b0, k):
    """bench.py's chain: out -> y, dX -> g, s and b stepped by 1e-6 of
    their gradients, k times."""
    y, gg, s, b = x, g, s0, b0
    for _ in range(k):
        out, dx, ds, db = fn(y, gg, s, b)
        y, gg, s, b = out, dx, s - 1e-6 * ds, b - 1e-6 * db
    return y, gg, s, b


def _chain_inputs(torch, spec, shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, device="cuda", generator=g)
    gr = torch.randn(shape, device="cuda", generator=g)
    c = shape[spec.axis] if spec.per_channel else 1
    if spec.per_channel:  # symmetric weights: ±127 steps of 0.02 cover ±2.5
        s0, b0 = torch.full((c,), 0.02, device="cuda"), torch.zeros(c, device="cuda")
    else:  # bench.py's s0 = 0.1, b0 = 0.05
        s0, b0 = torch.full((1,), 0.1, device="cuda"), torch.full((1,), 0.05, device="cuda")
    return x, gr, s0, b0


def _check_fused_plain(torch, x, g, s, b, spec, kind):
    """One fq_fwdbwd_* call against the plain pair on the card: out and dX
    bit-equal, dS/dB within 1e-5 of their term sums (phase 2's rule);
    returns the largest absolute error."""
    from jaxlsq_torch.core.golden import (effective_grad_scale, golden_backward,
                                          golden_forward)
    from jaxlsq_torch.ops import fake_quant_fwdbwd

    out, dx, ds, db = fake_quant_fwdbwd(g, x, s, b, spec=spec)
    ref = golden_forward(x, s, b, spec)
    rdx, rds, rdb = golden_backward(g, x, s, b, spec)
    torch.cuda.synchronize()
    if not (torch.equal(out, ref) and torch.equal(dx, rdx)):
        raise AssertionError(f"chain {kind}: fq_fwdbwd_{kind} out/dX differ from the plain "
                             f"pair by {float((out - ref).abs().max())}, "
                             f"{float((dx - rdx).abs().max())}")
    del out, dx, ref, rdx
    gs = effective_grad_scale(spec, x.numel(), s.numel())
    err = 0.0
    for got, want, tot in zip((ds, db), (rds, rdb),
                              _fq_term_sums(torch, g, x, s, b, spec, False, gs)):
        e = (got.double() - want.double()).abs().reshape(tot.shape)
        if not bool((e <= 1e-5 * tot).all()):
            raise AssertionError(f"chain {kind}: fq_fwdbwd_{kind} dS/dB off the plain "
                                 f"pair by {float(e.max())}")
        err = max(err, float(e.max()))
    return err


def phase_chain(torch, rec):
    """Phase 11: jaxlsq's headline fake-quant fwd+bwd chain (bench.py:484-628)
    on the port, per tensor at 64 Mi elements and per channel on an (8192,
    8192) weight: the split leg (autograd: fq_fwd_* + fq_bwd_*), the fused
    leg (fq_fwdbwd_*), the plain pair and the library's learnable fake
    quant, each timed as the slope between 2 and 8 chained iterations
    (interleaved rounds, min of rounds), beside a one-read-one-write stream
    probe.  Fails unless after 8 iterations the fused and split legs' y, g,
    s and b are bit-equal and finite, the fused leg ran fq_fwdbwd_* and the
    split leg no fused kernel, and unless one fused call on the chain's
    inputs matches the plain pair (``_check_fused_plain``); that error is
    the kernels line's ``max_abs_err`` for fq_fwdbwd_*."""
    from jaxlsq_torch.ops.fake_quant import (fake_quant_backward, fake_quant_forward,
                                             fake_quant_fwdbwd)
    from jaxlsq_torch.core.golden import golden_backward, golden_forward

    out = rec["chain"] = {}
    _, _, fq = reset_counts()
    finals = {}
    for kind, (spec, shape) in _chain_specs().items():
        x, gr, s0, b0 = _chain_inputs(torch, spec, shape, seed=21)
        legs = _chain_legs(torch, spec)
        for leg in ("split", "fused"):
            before = dict(fq)
            finals[kind, leg] = _chain(legs[leg], x, gr, s0, b0, CHAIN_K2)
            torch.cuda.synchronize()
            ran = {k: fq[k] - before[k] for k in fq if fq[k] != before[k]}
            want = ({f"fq_fwd_{kind}": CHAIN_K2, f"fq_bwd_{kind}": CHAIN_K2} if leg == "split"
                    else {f"fq_fwdbwd_{kind}": CHAIN_K2})
            if ran != want:
                raise AssertionError(f"chain {kind} {leg}: launches {ran}, not {want}")
        a, b_ = finals[kind, "split"], finals[kind, "fused"]
        if not all(torch.equal(u, v) for u, v in zip(a, b_)):
            raise AssertionError(f"chain {kind}: the fused leg's y, g, s, b after "
                                 f"{CHAIN_K2} iterations differ from the split leg's")
        if not all(bool(torch.isfinite(t).all()) for t in b_):
            raise AssertionError(f"chain {kind}: non-finite values")
    out["launches"] = {k: fq[k] for k in FQ_KERNELS + FUSED_KERNELS}
    log(f"[chain] {CHAIN_K2} iterations per tensor {CHAIN_SHAPE} and per channel "
        f"{CHAIN_PC_SHAPE}: fused = split bit for bit (y, g, s, b), finite; launches "
        f"{out['launches']}")
    del finals

    times = rec["times"]
    rec["max_abs_err_quantizer_shapes"] = {k: rec["max_abs_err"][k] for k in FUSED_KERNELS}
    for kind, (spec, shape) in _chain_specs().items():
        n = math.prod(shape)
        x, gr, s0, b0 = _chain_inputs(torch, spec, shape, seed=21)
        err = rec["max_abs_err"][f"fq_fwdbwd_{kind}"] = _check_fused_plain(
            torch, x, gr, s0, b0, spec, kind)
        log(f"[chain] {kind} {shape}: one fq_fwdbwd_{kind} call = the plain pair on the "
            f"card (out, dX bit-equal; dS/dB within 1e-5 of their term sums, max abs "
            f"err {err:.3e}; at the quantizer shapes of phase 2 "
            f"{rec['max_abs_err_quantizer_shapes'][f'fq_fwdbwd_{kind}']:.3e})")
        zp0 = -b0 / s0  # the library's float zero point for the same grid
        legs = _chain_legs(torch, spec)
        args = {leg: (x, gr, s0, zp0 if leg == "library" else b0) for leg in legs}

        def stream(k):
            y = x
            for _ in range(k):
                y = y * 1.000001
            return y

        runs = {leg: [[], []] for leg in list(legs) + ["stream"]}
        for _ in range(CHAIN_ROUNDS):
            for leg, fn in legs.items():
                for j, k in enumerate((CHAIN_K1, CHAIN_K2)):
                    runs[leg][j].append(events_ms(
                        lambda: _chain(fn, *args[leg], k))[0])
            for j, k in enumerate((CHAIN_K1, CHAIN_K2)):
                runs["stream"][j].append(events_ms(lambda: stream(k))[0])
        slope = {leg: max((min(r[1]) - min(r[0])) / (CHAIN_K2 - CHAIN_K1), 1e-9)
                 for leg, r in runs.items()}
        achievable = 8 * n / slope["stream"] / 1e6  # GB/s
        res = {"shape": list(shape), "elements": n, "ms_per_iteration": slope,
               "achievable_gbps": achievable, "legs": {}}
        for leg in legs:
            gbps = CANON_BYTES * n / slope[leg] / 1e6
            res["legs"][leg] = {"ms": slope[leg], "gbps_20B": gbps,
                                "frac_of_3.35TB/s": gbps / (HBM_BYTES_PER_S / 1e9),
                                "frac_of_achievable": gbps / achievable}
        res["legs"]["fused"]["real_gbps_16B"] = FUSED_BYTES * n / slope["fused"] / 1e6
        res["bound_ms_20B"] = CANON_BYTES * n / HBM_BYTES_PER_S * 1e3
        res["bound_ms_16B"] = FUSED_BYTES * n / HBM_BYTES_PER_S * 1e3
        out[kind] = res
        log(f"[chain] {kind} {shape}: ms an iteration "
            + ", ".join(f"{k} {v:.4f}" for k, v in slope.items())
            + f"; stream {achievable:.1f} GB/s; at 20 B/elem: "
            + ", ".join(f"{leg} {r['gbps_20B']:.1f} GB/s ({100 * r['frac_of_3.35TB/s']:.1f}% "
                        f"of 3.35 TB/s, {100 * r['frac_of_achievable']:.1f}% of the stream)"
                        for leg, r in res["legs"].items())
            + f"; fused real rate {res['legs']['fused']['real_gbps_16B']:.1f} GB/s "
            f"(bounds {res['bound_ms_20B']:.3f} ms at 20 B, {res['bound_ms_16B']:.3f} ms "
            "at 16 B)")

        # the fused kernel alone, for the kernels line
        s_l, zp_l = s0.clone().requires_grad_(True), zp0.clone().requires_grad_(True)
        x_l = x.clone().requires_grad_(True)

        def lib(xx, gg):
            if spec.per_channel:
                y = torch._fake_quantize_learnable_per_channel_affine(
                    xx, s_l, zp_l, spec.axis, spec.quant_min, spec.quant_max, 1.0)
            else:
                y = torch._fake_quantize_learnable_per_tensor_affine(
                    xx, s_l, zp_l, spec.quant_min, spec.quant_max, 1.0)
            return torch.autograd.grad(y, (xx, s_l, zp_l), gg)

        name = f"fq_fwdbwd_{kind}"
        ms, call = measure(lambda xx, gg: fake_quant_fwdbwd(gg, xx, s0, b0, spec=spec),
                           [(x, gr)])
        plain, _ = measure(lambda xx, gg: (golden_forward(xx, s0, b0, spec),
                                                  golden_backward(gg, xx, s0, b0, spec)),
                           [(x, gr)], reps=10)
        split_ms, _ = measure(lambda xx, gg: (fake_quant_forward(xx, s0, b0, spec),
                                                     fake_quant_backward(gg, xx, s0, b0, spec)),
                              [(x, gr)])
        lib_ms, lib_call = measure(lib, [(x_l, gr)])
        b_ms, b_by = bound(FUSED_BYTES * n, 27 * n)
        times[name] = {"shape": list(shape), "ms": ms, "call_ms": call, "plain_ms": plain,
                       "split_ms": split_ms, "library_ms": lib_ms,
                       "library_call_ms": lib_call, "bound_ms": b_ms, "bound_by": b_by,
                       "bytes": FUSED_BYTES * n, "ops": 27 * n}
        log(f"[time] {name} {shape}: {ms * 1e3:.1f} us on the device, {call * 1e3:.1f} us "
            f"a call (bound {b_ms * 1e3:.1f} us by {b_by}; the split pair fq_fwd_{kind} + "
            f"fq_bwd_{kind} {split_ms * 1e3:.1f} us; plain {plain * 1e3:.1f} us; "
            f"library learnable fake quant forward + backward {lib_ms * 1e3:.1f} us)")
        del x, gr, x_l, args, legs


def _lab_bytes(m):
    """An int4 lab call's bytes: the packed weights, x, out and the scale."""
    return LAB_K * LAB_N // 2 + 4 * (m * LAB_K + m * LAB_N + LAB_N)


def lab_bound(m, passes):
    """The least time of an int4 lab call on the tensor cores: its bytes, or
    ``passes`` bf16 passes of 2 M K N (wo4_bf16 one, wo4_native three)."""
    tb = _lab_bytes(m) / HBM_BYTES_PER_S * 1e3
    tf = passes * 2 * m * LAB_K * LAB_N / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


LAB_KERNELS = (("wo4_bf16", "int4_bf16", 1, "lib_matmul_bf16"),
               ("wo4_native", "int4_native", 3, "lib_matmul_f32"))


def phase_int4_lab(torch, rec):
    """Phase 12: the int4 kernel lab (``lab.int4_kernel_lab.run_lab``) at
    M in {1, 16, 128}, K = N = 8192: ``wo8``, ``wo4``, ``wo4_bf16`` and
    ``wo4_native``, each against ``wo_matmul_plain`` at its own bits, timed
    beside the plain versions and two library matmuls.  Fails unless
    ``wo4_bf16`` and ``wo4_native`` are within 1e-4·max|ref| of their plain
    versions and ``wo4_native`` within that of ``wo4`` on the same values,
    every row of both is the same bits at every M, and both lab kernels
    ran."""
    from jaxlsq_torch.lab.int4_kernel_lab import LAUNCHES as LAB
    from jaxlsq_torch.lab.int4_kernel_lab import run_lab

    reset_counts()
    res = run_lab(LAB_MS, LAB_K, LAB_N, rounds=LAB_ROUNDS)
    torch.cuda.synchronize()
    rec["int4_lab"] = {"K": LAB_K, "N": LAB_N, "results": res, "launches": dict(LAB)}
    errs = []
    for m in LAB_MS:
        r = res[f"M{m}"]
        errs += [r["int4_bf16"]["rel_err_vs_plain"], r["int4_native"]["rel_err_vs_plain"],
                 r["int4_native"]["rel_err_vs_int4_cur"]]
        b_ms, b_by = bound(_lab_bytes(m), 2 * m * LAB_K * LAB_N)
        r["int4_bound"] = {"ms": b_ms, "by": b_by}
        log(f"[lab] M={m} K={LAB_K} N={LAB_N} (int4 f32 CUDA-core bound {b_ms * 1e3:.1f} us "
            f"by {b_by}; tensor-core bounds "
            + ", ".join(f"{name} {lab_bound(m, ps)[0] * 1e3:.1f} us"
                        for name, _, ps, _ in LAB_KERNELS) + "): "
            + "; ".join(f"{k} {v['ms'] * 1e3:.1f} us"
                        + (f" ({v['w_gbps']:.0f} GB/s of weights, err {v['max_rel_err']:.1e} "
                           "of max|ref| vs wo_matmul_plain)" if "w_gbps" in v else "")
                        for k, v in r.items() if isinstance(v, dict) and "ms" in v))
    rec["max_abs_err"]["wo4_bf16"] = max(res[f"M{m}"]["int4_bf16"]["abs_err_vs_plain"]
                                         for m in LAB_MS)
    rec["max_abs_err"]["wo4_native"] = max(res[f"M{m}"]["int4_native"]["abs_err_vs_plain"]
                                           for m in LAB_MS)
    if not max(errs) <= 1e-4:
        raise AssertionError(f"the int4 lab kernels disagree: {errs}")
    if not all(res["rows_same_bits"].values()):
        raise AssertionError(f"the int4 lab kernels' rows change with M: "
                             f"{res['rows_same_bits']}")
    if not all(LAB[k] > 0 for k in LAB):
        raise AssertionError(f"the int4 lab did not launch its kernels: {LAB}")
    log(f"[lab] wo4_bf16 / wo4_native within {max(errs):.1e} of max|ref| of their plain "
        f"versions and of wo4, every row the same bits at M = {LAB_MS}; launches "
        f"{dict(LAB)}")
    times = rec["times"]
    for name, key, passes, lib in LAB_KERNELS:
        rows = []
        for m in LAB_MS:
            r = res[f"M{m}"]
            b_ms, b_by = lab_bound(m, passes)
            rows.append({"M": m, "K": LAB_K, "N": LAB_N, "ms": r[key]["ms"],
                         "plain_ms": r[f"{key}_plain"]["ms"], "library_ms": r[lib]["ms"],
                         "bound_ms": b_ms, "bound_by": b_by,
                         "bound_f32_cuda_cores_ms": bound(_lab_bytes(m),
                                                          2 * m * LAB_K * LAB_N)[0]})
        times[name] = rows


def kernels_line(rec):
    out = []
    for name, src, repl in (
            ("wo8", "jaxlsq_torch/csrc/wo_matmul.cu", "jaxlsq/serve/matmul.py:69"),
            ("wo4", "jaxlsq_torch/csrc/wo_matmul.cu", "jaxlsq/serve/matmul.py:93")):
        rows = [r for r in rec["times"][name] if r["M"] == 1]
        nbytes = sum(r["bytes"] for r in rows)
        flops = sum(r["flops"] for r in rows)
        b_ms, b_by = wo_bound(name, nbytes, flops)
        out.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                    "launches": rec["launches"][name],
                    "max_abs_err": rec["max_abs_err"][name],
                    "ms": sum(r["ms"] for r in rows),
                    "plain_ms": sum(r["plain_ms"] for r in rows),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "bound_f32_cuda_cores_ms": bound(nbytes, flops)[0],
                    "library_ms": sum(r["library_ms"] for r in rows),
                    "by_m": {m: {k: sum(r[k] for r in rec["times"][name] if r["M"] == m)
                                 for k in ("ms", "bound_ms", "library_ms")}
                             for m in (1, 8, 256)},
                    "shape": "M=1, sum over qkv/proj/mlp_up/mlp_down/lm_head of "
                             "the d1024 LM (one of each per B=1 decode step); by_m: "
                             "the sums at M=1, 8, 256; bound: three bf16 tensor-core "
                             "passes or the bytes"})
    rows = [r for r in rec["times"]["wo4g"] if r["M"] == 1]
    b_ms, b_by = bound(sum(r["bytes"] for r in rows), sum(r["flops"] for r in rows))
    out.append({"name": "wo4g", "route": "cuda", "source": "jaxlsq_torch/csrc/wo_matmul.cu",
                "replaces": "jaxlsq/serve/matmul.py:147",
                "launches": rec["paged"]["launches"]["wo4g"],
                "max_abs_err": rec["max_abs_err"]["wo4g"],
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": sum(r["library_ms"] for r in rows),
                "shape": f"M=1, group {GROUP}, sum over qkv/proj/mlp_up/mlp_down/lm_head "
                         "of the d1024 LM (one of each per B=1 decode step)"})
    r = next(x for x in rec["times"]["paged_attention"] if x["page_size"] == PAGE)
    out.append({"name": "paged_attention", "route": "cuda",
                "source": "jaxlsq_torch/csrc/decode_attention.cu",
                "replaces": "jaxlsq/serve/paged.py:225",
                "launches": rec["paged"]["launches"]["paged_attention"],
                "fold_launches": rec["paged"]["launches"]["paged_attention_fold"],
                "max_abs_err": rec["max_abs_err"]["paged_attention"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "shape": f"int8 pools, page {PAGE}, B=8, H=KVH=16, hd=64, L=2048, t=1, "
                         "all keys live"})
    r = rec["times"]["decode_attention"][0]
    out.append({"name": "decode_attention", "route": "cuda",
                "source": "jaxlsq_torch/csrc/decode_attention.cu",
                "replaces": "jaxlsq/serve/attention.py:63",
                "launches": rec["launches"]["decode_attention"],
                "fold_launches": rec["launches"]["decode_attention_fold"],
                "max_abs_err": rec["max_abs_err"]["decode_attention"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "shape": "int8 cache, B=8, H=KVH=16, hd=64, L=2048, t=1, all keys live"})
    for name, repl, leg in (
            ("fq_fwd_pt", "jaxlsq/ops/pallas_kernels.py:195", "train"),
            ("fq_fwd_pc", "jaxlsq/ops/pallas_kernels.py:268", "train"),
            ("fq_bwd_pt", "jaxlsq/ops/pallas_kernels.py:202", "train"),
            ("fq_bwd_pc", "jaxlsq/ops/pallas_kernels.py:275", "train"),
            ("fq_fwd_pt_traced", "jaxlsq/ops/pallas_kernels.py:680", "train_captured"),
            ("fq_fwd_pc_traced", "jaxlsq/ops/pallas_kernels.py:725", "train_captured"),
            ("fq_bwd_pt_traced", "jaxlsq/ops/pallas_kernels.py:689", "train_captured"),
            ("fq_bwd_pc_traced", "jaxlsq/ops/pallas_kernels.py:734", "train_captured")):
        t = rec["times"][name]
        kn = rec["times"].get(name + "_kn")  # per channel: also a (K, N) weight on axis 1
        out.append({"name": name, "route": "cuda",
                    "source": "jaxlsq_torch/csrc/fake_quant.cu", "replaces": repl,
                    "launches": rec[leg]["launches"][name],
                    "max_abs_err": rec["max_abs_err"][name],
                    "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                    **({"axis1": {k: kn[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                                     "bound_by", "library_ms")}}
                       if kn else {}),
                    "shape": ("x " + "x".join(map(str, t["shape"]))
                              + (", train mode; library: forward + backward"
                                 if "bwd" in name else "")
                              + ("; axis1: the same at the LM head's weight" if kn
                                 else ""))})
    for name, repl in (("fq_fwdbwd_pt", "jaxlsq/ops/pallas_kernels.py:607"),
                       ("fq_fwdbwd_pc", "jaxlsq/ops/pallas_kernels.py:639")):
        t = rec["times"][name]
        out.append({"name": name, "route": "cuda",
                    "source": "jaxlsq_torch/csrc/fake_quant.cu", "replaces": repl,
                    "launches": rec["chain"]["launches"][name],
                    "max_abs_err": rec["max_abs_err"][name],
                    "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                    "shape": ("x " + "x".join(map(str, t["shape"])) + ", train mode; "
                              "library: learnable fake quant forward + backward")})
    for name, repl in (("wo4_bf16", "examples/_int4_kernel_lab.py:50"),
                       ("wo4_native", "examples/_int4_kernel_lab.py:72")):
        rows = rec["times"][name]
        t = rows[0]  # M = 1; every M in by_m
        out.append({"name": name, "route": "cuda",
                    "source": "jaxlsq_torch/csrc/int4_lab.cu", "replaces": repl,
                    "launches": rec["int4_lab"]["launches"][name],
                    "max_abs_err": rec["max_abs_err"][name],
                    "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"],
                    "bound_f32_cuda_cores_ms": t["bound_f32_cuda_cores_ms"],
                    "library_ms": t["library_ms"], "by_m": rows,
                    "shape": (f"M={t['M']} (by_m: M={', '.join(str(r['M']) for r in rows)}), "
                              f"K={t['K']}, N={t['N']}; bound: "
                              + ("one bf16 tensor-core pass" if name == "wo4_bf16"
                                 else "three bf16 tensor-core passes")
                              + "; library: torch.matmul on the "
                              + ("bf16 x and dequantized bf16 weight" if name == "wo4_bf16"
                                 else "dequantized f32 weight"))})
    r = rec["times"]["flash"][0]
    for name, repl, lib, what in (
            ("flash_fwd", "jaxlsq/models/zoo.py:433 -> upstream "
                          "jax/experimental/pallas/ops/tpu/flash_attention.py:331",
             "sdpa_fwd_ms", "SDPA forward"),
            ("flash_bwd", "jaxlsq/models/zoo.py:433 -> upstream "
                          "jax/experimental/pallas/ops/tpu/flash_attention.py:796 "
                          "(dK/dV) and :1146 (dQ)",
             "sdpa_bwd_ms", "SDPA backward alone (autograd.grad, forward outside)")):
        t = r[name]
        out.append({"name": name, "route": "cuda",
                    "source": "jaxlsq_torch/csrc/flash_attention.cu", "replaces": repl,
                    "launches": rec["lm"]["launches"][name],
                    "max_abs_err": rec["max_abs_err"][name],
                    "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"],
                    "bound_f32_cuda_cores_ms": t["bound_f32_cuda_cores_ms"],
                    "library_ms": r[lib],
                    "shape": f"B={r['B']}, H={r['H']}, t={r['t']}, hd={r['hd']}, causal, "
                             f"f32; bound: 3xTF32 on the tensor cores; library: {what}"})
    return out


def main(argv):
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", help="also write the full record here (JSON)")
    record = parser.parse_args(argv).record

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {smi} | {kind} | torch {torch.__version__} CUDA {torch.version.cuda}"
        " | TF32 off for matmul and cuDNN")
    rec = {"card": smi, "kind": kind, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    t0 = time.time()
    phase_kernels(torch, rec)
    phase_flash_kernels(torch, rec)
    phase_fq_kernels(torch, rec)
    phase_lm_fq_kernels(torch, rec)
    phase_main(torch, rec)
    phase_paged(torch, rec)
    phase_times(torch, rec)
    phase_fq_times(torch, rec)
    phase_train(torch, rec)
    phase_train_captured(torch, rec)
    phase_captured_vs_eager(torch, rec)
    phase_lm(torch, rec)
    phase_flash_times(torch, rec)
    phase_chain(torch, rec)
    phase_int4_lab(torch, rec)
    rec["wall_s"] = time.time() - t0
    rec["profile_misses"] = PROFILE_MISSES
    rec["waiting_calls"] = WAITING_CALLS
    rec["kernels"] = kernels_line(rec)
    if record:
        os.makedirs(os.path.dirname(os.path.abspath(record)), exist_ok=True)
        with open(record, "w") as f:
            json.dump(rec, f, indent=1)
    log(f"[done] {rec['wall_s']:.1f} s")
    log(json.dumps({"kernels": rec["kernels"]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
