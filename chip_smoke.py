#!/usr/bin/env python3
"""Smoke test of the jaxlsq_torch port on one NVIDIA GPU (H100): the serving
slice, paged-KV serving of a group-wise int4 LM, the QAT training slice, its
single-program (CUDA-graph) step, long-context LSQ QAT of the LM through
the flash-attention kernels, then serving the trained LM; jaxlsq's headline
fake-quant fwd+bwd chain through the fused kernel, the int4 kernel lab, the
conv nets' train-then-serve, the observers, a stock third-party model, the
decode features (QAT decode, beam search, speculative decoding and its
engines, ServingEngine), and the int8 x int8 serving path and the quantized
MoE, and the tooling (sensitivity and mixed-precision planning, torch.export
of the serving programs, the host C++ oracle and shard loader), the
multi-device steps and the pipeline.

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
   for ``wo4_native``);
13. conv-net train-then-serve: full-width ``mobilenetv2_cifar`` (36
   classes) at B = 128 on the grating task of examples/accuracy_parity.py
   (drawn on the card), under combo1200's qconfig with a 20-batch window:
   the static and traced fake-quant kernels at its 46 quantizer shapes on
   one eager step's real data (phase 2's gates); then, every launch count
   reset, the eager (30 steps) and captured (50 steps) legs under AdamW
   (weight decay 1e-4, ``capturable=True``) and the protocol's cosine lr,
   images/s past the window, launches a step, a profiled replay's kernels
   by kind; ``reestimate_batch_stats`` over 20 batches (fails unless every
   quantizer tensor is unchanged and every BatchNorm moved); convert and
   serve at w8a8 and w4a8 on 2,000 images (logits within 1e-4 of max|ref| of
   the QAT model's eval logits, every dequantized pack bit-equal to its
   fake-quantized weight, the classifier through ``wo8``/``wo4``); one B = 8
   step against the CPU plain path (phase 6's rule); eager = captured from
   one state over 5 steps across a 2-batch window (phase 8's rule); and
   ``wo8``/``wo4`` at M = 2,000, K = 256 and 512, N = 36 against
   ``wo_matmul_plain`` (1e-4 of max|ref|).

14. the expensive observers on full-width ``mobilenetv2_cifar`` at B = 128:
   ``mse_range``, ``hist_update`` and ``hist_search`` (``csrc/observers.cu``)
   against their plain versions at its 23 activation shapes on one step's
   real data and at ragged sizes (the MSE kernel per tensor and per
   channel: the chosen candidate the plain one's, or within 1e-5 of its
   least error; a fresh histogram's counts exact, a widened one's bins
   within 1e-6 of its mass, and the same ranges; the search's range and trips the plain loop's on the CPU), each
   the same bits on a rerun and silent with its gate off, and timed there
   beside its bound and its plain version; then, every launch count reset,
   the captured step under ``qat_optimizer(AdamW(capturable=True))`` for the
   min/max, MSE, percentile and histogram configs (a 20-batch window; the
   observer kernels launched 23 times in the warm-up and in the capture and
   never by a replay), a post-window replay of each in turns (fails if the
   MSE config's is more than 5% over the min/max one's), eager = captured
   from one state over 5 steps across a 2-batch window for each expensive
   observer, ``calibrate`` over 20 batches then convert and serve at w8a8
   (phase 13's logits rule), and a B = 8 step against the CPU plain path
   (phase 6's rule) for each.
15. third-party models: a full-width stock ResNet-18 written from
   ``torch.nn`` alone (``jaxlsq_torch/lab/stock_resnet.py``) through
   ``quantize_model`` under __graft_entry__.py's qconfig with a 2-batch
   window: the fake-quant kernels at its 42 quantizer shapes (the Linear
   head's (10, 512) weight per channel on axis 0 among them) on one eager
   step's real data, static and traced, by phase 13's rule; the 21 swapped
   layers, the stock keys kept, a float state dict missing only quantizer
   keys; then, every launch count reset, 12 eager
   and 12 captured steps at B = 64 (the launches a step, ms a step and a
   replay, profiles by category beside phases 6-7's hand-built resnet, the
   stock BatchNorms alone against the port's flax-rule ones), a B = 8 step
   against the CPU plain path (phase 6's rule), eager = captured over 5
   steps (phase 8's rule), a checkpoint at step 2 restored by
   ``restore_or_init`` into a fresh model and optimizer that then capture
   and run 3 more steps equal to the uninterrupted run in every leaf,
   captured steps under ``distillation_loss`` against the float stock model
   (its ms beside the plain replay's, a B = 8 step against the CPU, the
   teacher unchanged), convert and serve at w8a8 and w4a8 (phase 13's
   logits rule, the head through ``wo8``/``wo4`` by the counts and the
   profiler), and ``reestimate_batch_stats`` (every stock BatchNorm moved,
   no quantizer tensor changed).
16. decode features, every launch count reset: bench.py's real-draft
   speculative pair (``lab/speculative_decode.py``: a d1024 x 4 target and a
   d128 x 1 draft, vocab 512, trained on its Markov corpus by captured QAT
   steps, cut to SPEC_TARGET_STEPS / SPEC_DRAFT_STEPS); ``make_generate`` on
   the QAT-mode target and on phase 9's per-channel rope LM through the
   cache branch (logits within 1e-4 of max|ref| of the full eval forward and
   of the CPU, every quantizer tensor unchanged); the pair converted to int8:
   speculative greedy (k = 4) equal to greedy bit for bit, the verify's rows
   equal to the t = 1 steps' bits (else the first module that differs is
   named), tokens/s from the 16 -> 208 slope beside plain, kernels and host
   reads a round, speculative sampling and the target as its own draft
   (k + 1 a round); ``SpeculativeDecodeEngine`` and
   ``PagedSpeculativeDecodeEngine`` over 16 staggered requests (8 on a
   prefix; a page-16 pool that defers), each equal to its B = 1 greedy
   decode, paged = dense; ``make_beam_search`` on phase 3's LM and its w4
   twin (beams=1 = greedy; beam-4 scores against a teacher-forced rescoring;
   the CPU's tokens, or a tie); ``ServingEngine`` over a calibrated w8a8
   ``mobilenetv2_cifar``: one CUDA graph a bucket, each result the bits of
   the eager forward of its padded batch.
17. the int8 x int8 path and the MoE: ``act_quant_i8`` and ``i8mm``
   (``csrc/int8_matmul.cu``) bit-equal to their plain versions and across
   two runs at every (M, K, N) of INT8_MS x INT8_KS x INT8_NS (signed and
   shifted unsigned activations; per-channel, per-tensor and affine
   weights; the dynamic mode), on NaN, +-inf and zeros, over E = 8 expert
   stacks with per-expert qparams and at mobilenetv2's conv shapes
   (symmetric and affine); ``i8mm``'s forms (``serve.matmul.i8mm_plan``):
   static and dynamic layers at M on either side of every row tile's and
   the fusion's threshold, and every tile and cluster size the plan can
   give, unfused and with the quantization fused into ``i8mm`` (NaN and
   +-inf in x); the fake-quant kernels at the MoE LM's per-expert shapes
   (phase 2's gates); then, every launch count reset:
   the d1024 x 4 LM at w8, calibrated on 4 token batches and served
   'static_int8' (prefill logits within 1e-4 of max|ref| of 'static', a
   dense layer's input a level over handed over as deviation 14, at most
   1e-4 of the elements) and 'dynamic' (``make_generate`` at B = 1 and 8;
   every dynamic matmul of a decode step within 2e-2 of x @ dequant(W));
   decode tokens/s beside 'none' and the kernels a token, and each mode's
   profiled B = 1 generate (kernels a token, device busy share); w8a8
   mobilenetv2_cifar at B = 128 (every conv and the classifier bit-equal to
   their plain versions, one ``i8mm`` a layer and one ``act_quant_i8`` a
   conv, the classifier's rows quantized inside ``i8mm`` up to FUSED_MAX_M,
   logits within 5e-3 of 'static'; ``ServingEngine`` over it, a graph a
   bucket, replays = eager); the d1024 x 4 MoE LM (8 experts of 4096, top
   2, capacity 1.25) trained MOE_STEPS steps at B = 8, t = 256 eager and
   captured from one state, equal leaf by leaf, its aux loss finite and
   positive and its dropped picks printed; converted at w8 and w4 expert
   stacks and served at capacity E / top_k: ``make_generate`` at B = 1 and
   8 within 1e-4 of the full forward, ``DecodeEngine`` = B = 1 decodes,
   'static_int8' within 1e-4 of 'static' (routing picks handed over only at
   a near-tie of the reference's gates, at most 1e-3 of the tokens); then
   both kernels, the fused path and the static layer as served timed at
   the d1024 shapes beside ``wo8``, ``torch._int_mm`` and
   ``torch.quantize_per_tensor``, and the fused path against I1 + I2 at M =
   32, 64 and 128 (the fusion's crossover).

18. the tooling, inside ``utils.profiling.trace`` (each leg an ``annotate``
   span, found in the trace file after) with every launch count reset:
   combo1200_4's w4a8 ``mobilenetv2_cifar``, calibrated on 4 grating
   batches and trained 4 captured steps at B = 128: ``sensitivity_report``
   and ``plan_mixed_precision`` (weights at 4 or 8 bits, 4.8 on average) on
   the card (the fake-quant kernels counted, every quantizer tensor
   bit-identical after each), then both on the card and on the CPU from the
   same state on 8 images (every loss within 1e-4 relative, the assignments
   equal but at near ties of the damage-per-byte gains, printed and
   counted); the plan's qconfig trained 4 captured steps (``StepTimer``),
   converted and served (phase 13's rules, the classifier through the wo
   kernel of its planned width, packs at both widths) and
   ``serving_size_report`` beside the uniform w4 and w8 conversions; phase
   3's LM in QAT mode at w4, calibrated and planned the same way, served
   'static' (logits within 1e-4 of max|ref| of the planned QAT model's,
   deviation 14's hand-over) and through ``make_generate`` at B = 1 over both
   ``wo8`` and ``wo4``; ``torch.export`` of phase 3's LM at w8 and w4 (f32
   cache, B = 1: the forward and the greedy generate of 16 + 32 tokens) and
   its 'static_int8' forward, each blob under 1 MB, replayed in a fresh
   process that imports ``torch`` and ``serve.custom_ops`` only, bit-equal
   to the eager forward and ``make_generate``, its launches and the
   profiler's kernel names the hand-written kernels'; the host C++ oracle
   (``jaxlsq_torch.native``) against the fake-quant kernels (phase 2's
   gates) and ``NativeShardLoader`` feeding 4 eager resnet18_cifar steps at
   B = 64 from seeded shards, each batch the rows the loader's contract
   names.

19. multi-device: torchrun's variables set here (a free port, world size
   1) and ``parallel.initialize_distributed()`` (NCCL), a 1 x 1 mesh, cuDNN
   deterministic, every count reset before each leg: resnet18_cifar at B =
   64 through the mesh step for 3 steps, eager and captured, every leaf and
   the losses bit-equal to the meshless step (the captured step's
   collectives issued at the warm-up and the capture, none at a replay;
   a replay timed beside the meshless one); FSDP (``fsdp_sharding``) of a
   1024-wide ``QuantMLP`` and of resnet18_cifar, bit-equal to the meshless
   steps; the EP (``moe_sharding`` over a (data, expert) mesh) MoE LM of
   phase 17 at depth 2, B = 4, t = 128, eager and captured, bit-equal; phase
   3's LM under ``serve.shard_converted``: ``make_generate`` at B = 4 with
   the dense and the paged int8 cache, tokens equal to the meshless model's;
   the collectives of each leg printed.  Then two gloo ranks of this script
   (``--gloo-rank``) on the one card: the resnet DP step at B = 64 over the
   ranks within 2e-5 of each leaf's largest magnitude (1e-5 of the loss) of
   the one-process step on the full batch on every rank, and the d1024
   LM's TP forward within 1e-5 of the unsharded one with greedy tokens
   equal on every rank.

20. the pipeline (``parallel.pipeline``) on phase 3's LM in QAT mode (16
   heads, rope, per-channel w8a8), B = 16, t = 256, 4 microbatches, every
   count reset first: (a) world size 1 on NCCL, a (1, 1) mesh, 3 steps in
   learning mode against ``make_train_step(accum_steps=4)`` (within the
   CPU tests' tolerances, bit-equality reported), captured and remat
   bit-equal to eager, a window closing in step 2 with the accumulation
   step's losses and observer state and its scale gradients deferred; (b)
   four gloo ranks of this script (``--gloo-leg pipeline``) on the one card
   over (data 1, stage 4) and (data 2, stage 2), every rank's leaves within
   2e-5 of each leaf's largest magnitude (the loss 1e-5) of (a)'s
   one-process pipeline (the (2, 2) leg with its gradient scale pinned,
   deviation 14's hand-over counted), 2·(S − 1)·MB sends a step, each
   rank's parameter bytes; (c) the state gathered into one plain LM, its
   eval logits within 1e-5 of the stage's, served at w8 and w4 (16 + 32
   tokens, ``wo8``/``wo4`` and ``decode_attention`` profiled); (d)
   ``lab.parallel_qat`` at world size 1 for 10 steps.

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
F32_EPS = 2.0 ** -23
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
# conv-net train-then-serve: mobilenetv2_cifar on the grating task of
# examples/accuracy_parity.py (36 classes, 32x32x3), 22 convs and the
# classifier, a weight and an activation quantizer each
MNV2_B, MNV2_CLASSES, MNV2_QUANTIZERS = 128, 36, 46
MNV2_WINDOW, MNV2_TIMED, MNV2_EAGER_TIMED = 20, 30, 10
MNV2_PROTOCOL_STEPS, MNV2_BN_BATCHES, MNV2_EVAL_N = 1500, 20, 2000
# the expensive observers (phase 14): their kernels, ragged sizes for them,
# and the post-window replays timed a config
OBS_KINDS = ("mse", "percentile", "histogram")
OBS_KERNELS = ("mse_range", "hist_update", "hist_search")
OBS_RAGGED = ((3, 7, 13, 17), (1000003,), (5, 3, 1, 1), (257,))
OBS_TIMED = 20
# third-party models (phase 15): a stock ResNet-18 swapped by quantize_model,
# its 20 convolutions and head quantized; a 2-batch observer window
STOCK_SWAPPED, STOCK_WINDOW, STOCK_EVAL_N = 21, 2, 2000
STOCK_DISTILL_STEPS, CKPT_K, CKPT_M = 8, 2, 3
# the decode features (phase 16): bench.py:192-257's real-draft speculative
# leg (k = 4, a 32-token prompt, 16 -> 208 new tokens), its pair's training cut
# from 1200 steps each; the speculative engines' 16 requests over page-16
# pools; beam search; ServingEngine's 200 requests
SPEC_K, SPEC_T0, SPEC_N1, SPEC_N2, SPEC_TEMP = 4, 32, 16, 208, 0.8
SPEC_N_PROFILED = 48  # kernels a round: profiles of 16 and 48 new tokens
SPEC_MAXLEN = SPEC_T0 + SPEC_N2 + SPEC_K + 8
SPEC_B, SPEC_TARGET_STEPS, SPEC_DRAFT_STEPS = 64, 100, 300
SPEC_REQUESTS, SPEC_PAGE, SPEC_PAGES = 16, 16, 24
BEAMS, ENGINE_REQUESTS, ENGINE_MAX_B, ENGINE_PASSES = 4, 200, 64, 4
MAX_DECODE_MOVED = 1e-4  # of a QAT decode's activation elements (deviation 14's CPU rule)
# the int8 x int8 path and the MoE (phase 17): ragged shapes for the kernels,
# the d1024 x 4 LM with 8 experts of 4 x 1024 hidden units, top-2 routing
INT8_MS, INT8_KS, INT8_NS = (1, 5, 17, 256), (27, 1000, 1024, 4096), (10, 36, 1024, 4096)
INT8_KERNELS = ("act_quant_i8", "i8mm")
INT8_TIMED_MS = (1, 8, 256)
MOE_E, MOE_TOP_K, MOE_CF, MOE_B, MOE_T, MOE_STEPS = 8, 2, 1.25, 8, 256, 6
MOE_SERVE_CF = MOE_E / MOE_TOP_K  # capacity never binds: routing per token
INT8_N1, INT8_N2 = 16, 64  # the decode slope of phase 17, one round (cut from 16 -> 208)
MAX_ROUTE_HANDED = 1e-3  # of the tokens: routing picks handed over at a near-tie
ROUTE_TIE = 1e-5
# the tooling (phase 18): combo1200_4's mobilenetv2 calibrated and trained a
# few captured steps, planned (4, 8) at 4.8 average bits; card against CPU on
# a few images; the d1024 x 4 LM exported (generate: 16 + 32 tokens); the
# shard loader feeding resnet18_cifar
TOOL_CALIB, TOOL_STEPS, TOOL_CPU_B, TOOL_TARGET, TOOL_REL = 4, 4, 8, 4.8, 1e-4
EXPORT_T0, EXPORT_NEW, EXPORT_MAX_BLOB = 16, 32, 1 << 20
TOOL_LM_LEN = 64  # the planned LM's max_len
LOADER_B, LOADER_STEPS, LOADER_SHARDS = 64, 4, (100, 90, 70)


def reset_counts():
    """Every kernel wrapper's launch count to 0; returns the count dicts."""
    from jaxlsq_torch.lab.int4_kernel_lab import LAUNCHES as LAB
    from jaxlsq_torch.ops.fake_quant import LAUNCHES as FQ
    from jaxlsq_torch.ops.flash_attention import LAUNCHES as FLASH
    from jaxlsq_torch.ops.observers import LAUNCHES as OBS
    from jaxlsq_torch.serve.attention import LAUNCHES as ATTN
    from jaxlsq_torch.serve.matmul import LAUNCHES as MM
    from jaxlsq_torch.serve.paged import LAUNCHES as PAGED

    for counts in (MM, ATTN, FQ, PAGED, FLASH, LAB, OBS):
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


def _profile_generate(torch, model, prompt, n_new=N2):
    from torch.profiler import ProfilerActivity, profile

    from jaxlsq_torch.serve import make_generate

    gen = make_generate(model, prompt.shape[1], n_new, cache_dtype=torch.bfloat16)
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
            "busy_share": dev_ms / (wall * 1e3), "kernels_per_token": n_kernels / n_new,
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
    every quantizer's input, qparams and incoming gradient captured."""
    caps = _capture_quantizers(torch, _resnet(torch, "cuda", seed=1),
                               _image_batches(torch, 1, TRAIN_B, seed=11)[0])
    if len(caps) != 42:
        raise AssertionError(f"captured {len(caps)} quantizers, expected 42 with gradients")
    return caps


def _capture_quantizers(torch, model, batch):
    """One eager SGD step of ``model`` on ``batch``, with every quantizer's
    input, qparams and incoming gradient captured by hooks."""
    from jaxlsq_torch.models.layers import FakeQuantize
    from jaxlsq_torch.parallel import make_train_step

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
    # in the observer window the stem's qparams take no gradient, so only
    # an image that does gives the stem's quantizer an incoming gradient
    batch["image"].requires_grad_(True)
    make_train_step(model, _sgd(torch, model), jit=False)(batch)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    if any("g" not in c for c in caps):
        raise AssertionError("a quantizer's output took no gradient")
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
    if any(k in n for k in ("bn_fw", "bn_bw", "batch_norm", "batchnorm")):
        return "batch_norm"
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


def _batchnorm_ms(torch, shapes, make=None):
    """Device ms and kernels of the BatchNorm layers' forward and backward
    in training mode at ``shapes``, on fresh layers (the port's flax-rule
    ``BatchNorm``, or ``make(channels)``) and random inputs."""
    from jaxlsq_torch.models import BatchNorm

    if make is None:
        def make(c):
            return BatchNorm(c, device="cuda")

    g = torch.Generator(device="cuda").manual_seed(6)
    layers = [(make(shp[1]),
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


def _cpu_check(torch, model, step, batch, cpu_model, label, cpu_loss_fn=None):
    """One training step from ``model``'s state on the card (``step``, on
    ``batch``) and on the CPU plain path (``cpu_model()``, a fresh CPU model
    of the same kind); the losses within 1e-3 relative.

    Matmuls and convolutions run their sums in another order on the two
    devices, so an activation can land on the other side of a rounding
    boundary and come out one quant step away; each such element moves every
    later layer a little and flips more of them.  So the CPU step takes the
    card's activation where the two differ by more than half a quant step,
    after checking that they differ by at most one step (and the two levels'
    f32 rounding), and fails if more
    than ``MAX_MOVED_SHARE`` of the elements were taken: a kernel that rounds
    wrong on a share of its elements fails here.  The loss without that
    hand-over is recorded beside it.  ``cpu_loss_fn()``, when given, makes
    the CPU step's loss function (default: cross entropy)."""
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
            # two adjacent levels (k - zp) * s differ by s up to the f32
            # rounding of each: an ulp of the largest level, 255 s at 8 bits
            # over the full range
            slack = 1e-5 * q + 2 * F32_EPS * float(out.detach().abs().max())
            if float(d.abs().max()) > q + slack:
                raise AssertionError(f"{n}: card and CPU activations differ by "
                                     f"{float(d.abs().max())}, more than a quant step {q}")
            moved[0] += int(far.sum())
            moved[1] += out.numel()
            return out + torch.where(far, d, torch.zeros_like(d))

        if hand_over:
            for n, m in _act_quantizers(cm):
                m.register_forward_hook(lambda mod, i, o, n=n: take_card(n, mod, o))
        kw = {} if cpu_loss_fn is None else {"loss_fn": cpu_loss_fn()}
        loss = float(make_train_step(cm, _sgd(torch, cm), jit=False, **kw)(cpu_batch)["loss"])
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


def _steps_equal(torch, models, opts, batches, toggle_at=None, schedule=None,
                 counts=None, per_step=None):
    """The eager (``models[0]``) and the captured (``models[1]``) step from one
    state over ``batches`` (act fake-quant toggled off before step
    ``toggle_at``; with ``schedule``, the lr set to ``schedule(i)`` before
    step i: the eager side fills its device lr (or writes a float where the
    lr is one), the captured side writes a Python float into
    ``group['lr']``): ``(leaves a step, losses, unequal leaves)``; a float
    leaf that is not bit-equal is recorded with its largest difference over
    its largest magnitude.  With ``counts`` (a launch-count dict) each step's
    launches on the eager and the captured side go into ``per_step``."""
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
                if torch.is_tensor(group["lr"]):
                    group["lr"].fill_(schedule(i))
                else:
                    group["lr"] = schedule(i)
            for group in opts[1].param_groups:
                group["lr"] = schedule(i)
        pair = []
        for side, s in zip(("eager", "captured"), steps):
            before = dict(counts or {})
            pair.append(s(batch)["loss"])
            if counts is not None:
                per_step.append({"step": i + 1, "side": side,
                                 **{k: counts[k] - before[k] for k in counts}})
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


# ---------------------------------------------------------------------------
# conv-net train-then-serve: mobilenetv2_cifar on the grating task
# ---------------------------------------------------------------------------

def _combo_qc(wbits, window):
    """combo1200's qconfig (examples/recipe_sweep.py:168; w4a8 at :234) with
    an observer window of ``window`` batches."""
    from jaxlsq_torch.models import default_qconfig

    return default_qconfig(wbits, 8, per_channel_weights=True, init_batches=window,
                           reduce_range=False)


def _mnv2(torch, device, wbits=8, window=MNV2_WINDOW):
    """Full-width mobilenetv2_cifar (36 classes) under combo1200's qconfig
    with an observer window of ``window`` batches."""
    from jaxlsq_torch.models import mobilenetv2_cifar

    return mobilenetv2_cifar(MNV2_CLASSES, _combo_qc(wbits, window), device=device, seed=0)


def _grating_batches(torch, n, b, seed):
    from jaxlsq_torch.lab.accuracy_parity import make_batch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [dict(zip(("image", "label"), make_batch(b, g, "cuda"))) for _ in range(n)]


def _adamw(torch, model):
    """The protocol's optimizer: AdamW with optax's weight decay, its lr on
    the card (a captured step reads it there)."""
    return torch.optim.AdamW(model.parameters(), lr=torch.tensor(3e-3, device="cuda"),
                             weight_decay=1e-4, capturable=True)


def _quantizer_state(model):
    from jaxlsq_torch.models.layers import FakeQuantize

    return {f"{n}.{k}": v.detach().clone() for n, m in model.named_modules()
            if isinstance(m, FakeQuantize)
            for k, v in list(m.named_parameters()) + list(m.named_buffers())}


def _mnv2_leg(torch, jit, steps, timed, fq, kernels):
    """``steps`` steps of a fresh w8a8 mobilenetv2_cifar at B = MNV2_B under
    the protocol's optimizer and cosine lr; images/s over the last ``timed``
    (past the observer window); the launches of ``kernels`` a step."""
    from jaxlsq_torch.lab.accuracy_parity import cosine_lr
    from jaxlsq_torch.parallel import make_train_step

    model = _mnv2(torch, "cuda")
    opt = _adamw(torch, model)
    step = make_train_step(model, opt, jit=jit)
    batches = _grating_batches(torch, steps + 1, MNV2_B, seed=21)
    torch.cuda.synchronize()
    losses, per_step, t_start = [], [], None
    for i, batch in enumerate(batches[:steps]):
        if i == steps - timed:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        for group in opt.param_groups:
            group["lr"] = cosine_lr(i, MNV2_PROTOCOL_STEPS)
        before = dict(fq)
        losses.append(step(batch)["loss"])
        per_step.append({k: fq[k] - before[k] for k in kernels})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    leg = {"steps": steps, "timed_steps": timed, "step_ms": 1e3 * wall / timed,
           "images_per_s": timed * MNV2_B / wall,
           "losses": torch.stack(losses).cpu().tolist(), "per_step_launches": per_step}
    if not all(math.isfinite(v) for v in leg["losses"]):
        raise AssertionError(f"non-finite mobilenetv2 loss: {leg['losses']}")
    return model, step, batches[steps], leg


def _mnv2_serve(torch, model, wbits, images, mm, fq):
    """The trained variables through convert into a serve-mode
    mobilenetv2_cifar (``load_variables``): its logits on ``images`` within
    1e-4 of max|ref| of the QAT model's eval logits on the same variables,
    every layer's dequantized pack bit-equal to its fake-quantized weight,
    and the classifier through wo8/wo4 (and no fake-quant kernel)."""
    from jaxlsq_torch import interop
    from jaxlsq_torch.models import QuantConv, QuantDense, mobilenetv2_cifar
    from jaxlsq_torch.ops.fake_quant import fake_quant_forward
    from jaxlsq_torch.parallel import make_eval_step
    from jaxlsq_torch.serve.pack import dequantize_weight

    served = mobilenetv2_cifar(MNV2_CLASSES, model.qconfig.for_serving("static"),
                               device="cuda")
    interop.load_variables(served, interop.qat_variables(model))
    served.eval()
    want = make_eval_step(model)({"image": images})
    before_mm, before_fq = dict(mm), dict(fq)
    with torch.no_grad():
        got = served(images)
    torch.cuda.synchronize()
    launches = {k: mm[k] - before_mm[k] for k in mm}
    fq_launches = sum(fq[k] - before_fq[k] for k in fq)
    err = float((got - want).abs().max())
    tol = 1e-4 * float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    packs_equal = 0
    layers = dict(served.named_modules())
    for name, mod in model.named_modules():
        if isinstance(mod, (QuantConv, QuantDense)):
            wf = mod.weight_fq
            fq_w = fake_quant_forward(mod.kernel.detach(), wf.scale.detach(),
                                      wf.shift.detach(), wf.cfg.spec)
            deq = dequantize_weight(layers[name].kernel.packed())
            if isinstance(mod, QuantConv):
                deq = deq.permute(3, 2, 0, 1)
            if not torch.equal(deq, fq_w):
                raise AssertionError(f"w{wbits}a8 {name}: dequant(pack(w)) != fake_quant(w)")
            packs_equal += 1
    kernel = "wo8" if wbits == 8 else "wo4"
    out = {"logits_err": err, "tol": tol, "top1_agreement": agree,
           "launches": launches, "fake_quant_launches": fq_launches,
           "packs_bit_equal": packs_equal}
    log(f"[convnet] served w{wbits}a8 mobilenetv2_cifar on {images.shape[0]} images: "
        f"logits vs the QAT model's eval logits max_abs_err {err:.3e} (tol {tol:.3e}), "
        f"argmax agreement {agree:.4f}; {packs_equal} packs dequantize to the "
        f"fake-quantized weights bit for bit; launches {launches}")
    if not (err <= tol and torch.isfinite(got).all()):
        raise AssertionError(f"w{wbits}a8 served logits disagree: {err} > {tol}")
    if launches[kernel] != 1 or fq_launches:
        raise AssertionError(f"w{wbits}a8: the served classifier ran {launches}, "
                             f"{fq_launches} fake-quant launches")
    return out


def _classifier_kernels(torch, rec):
    """wo8 (w8a8) and wo4 (w4a8) at the classifier's shape against
    wo_matmul_plain: M = 2,000, K = 256 (mobilenetv2's head) and 512
    (resnet18's), N = 36, within 1e-4 of max|ref|."""
    from jaxlsq_torch.core.spec import QuantSpec
    from jaxlsq_torch.serve.matmul import wo_matmul, wo_matmul_plain
    from jaxlsq_torch.serve.pack import quantize_weight

    g = torch.Generator(device="cuda").manual_seed(23)
    out = {}
    for k in (256, 512):
        w = torch.randn(k, MNV2_CLASSES, device="cuda", generator=g) * k ** -0.5
        x = torch.randn(MNV2_EVAL_N, k, device="cuda", generator=g)
        for bits, name in ((8, "wo8"), (4, "wo4")):
            spec = QuantSpec.weight_default(bits, per_channel=True, axis=1,
                                            reduce_range=False)
            p = quantize_weight(w, w.abs().amax(0) / spec.quant_max,
                                torch.zeros(MNV2_CLASSES, device="cuda"), spec, bits=bits)
            got, ref = wo_matmul(x, p), wo_matmul_plain(x, p)
            err = float((got - ref).abs().max())
            tol = 1e-4 * float(ref.abs().max())
            out[f"{name} K={k}"] = err
            if not err <= tol:
                raise AssertionError(f"{name} at M={MNV2_EVAL_N}, K={k}, N={MNV2_CLASSES}: "
                                     f"{err} > {tol}")
            rec["max_abs_err"][name] = max(rec["max_abs_err"][name], err)
    log(f"[convnet] the classifier's kernels at M={MNV2_EVAL_N}, N={MNV2_CLASSES} against "
        f"wo_matmul_plain (tol 1e-4 of max|ref|): {out}")
    return out


def phase_convnet(torch, rec):
    """Conv-net train-then-serve: full-width mobilenetv2_cifar at B = 128 on
    the grating task under combo1200's qconfig (a 20-batch window): the
    fake-quant kernels at its 46 quantizer shapes; the eager and captured
    training legs (images/s, launches a step, a profiled replay); one B = 8
    step against the CPU plain path; eager = captured from one state; BN
    re-estimation; convert and serve at w8a8 and w4a8; the classifier's
    kernels."""
    from jaxlsq_torch.lab.accuracy_parity import cosine_lr, make_batch
    from jaxlsq_torch.models import BatchNorm
    from jaxlsq_torch.parallel import make_train_step
    from jaxlsq_torch.utils import reestimate_batch_stats

    t0 = time.time()
    out = rec["convnet"] = {}
    # the kernels on one eager step's real activations, weights and gradients
    model = _mnv2(torch, "cuda")
    caps = _capture_quantizers(torch, model, _grating_batches(torch, 1, MNV2_B, 31)[0])
    if len(caps) != MNV2_QUANTIZERS:
        raise AssertionError(f"mobilenetv2_cifar has {len(caps)} quantizers, not "
                             f"{MNV2_QUANTIZERS}")
    del model
    errs = {k: 0.0 for k in FQ_KERNELS + TRACED_KERNELS + FUSED_KERNELS}
    worst = {False: 0.0, True: 0.0}
    for c in caps:
        for traced in (False, True):
            worst[traced] = max(worst[traced], _check_fq(
                torch, c["x"], c["scale"], c["shift"], c["g"], c["spec"], errs,
                f"mobilenetv2 {c['name']}", traced))
    for k, v in errs.items():
        rec["max_abs_err"][k] = max(rec["max_abs_err"][k], v)
    shapes = [{"name": c["name"], "shape": list(c["x"].shape),
               "per_channel": c["spec"].per_channel} for c in caps]
    out["fq_shapes"] = shapes
    big = max(math.prod(r["shape"]) for r in shapes)
    log(f"[convnet] fake-quant kernels at mobilenetv2_cifar's {len(shapes)} quantizer "
        f"shapes at B={MNV2_B} (largest {big} elements; depthwise weights "
        f"{sorted({tuple(r['shape']) for r in shapes if r['shape'][1:] == [1, 3, 3]})}), "
        "one eager step's real data, static and traced: forward and dX bit-exact; "
        f"dS/dB worst {worst[False]:.2e} / {worst[True]:.2e} of their term sums (tol 1e-5)")
    del caps

    # the main path, every count reset: eager and captured training, BN
    # re-estimation, convert and serve
    mm, _, fq = reset_counts()
    eager_model, _, _, eager = _mnv2_leg(torch, False, MNV2_WINDOW + MNV2_EAGER_TIMED,
                                         MNV2_EAGER_TIMED, fq, FQ_KERNELS)
    for i, counts in enumerate(eager["per_step_launches"]):
        for k, v in counts.items():
            # in the window the stem's activation quantizer reaches no parameter
            want = MNV2_QUANTIZERS // 2 - (k == "fq_bwd_pt" and i < MNV2_WINDOW)
            if v != want:
                raise AssertionError(f"eager step {i + 1}: {k} ran {v} times, not {want}")
    model, step, spare, cap = _mnv2_leg(torch, True, MNV2_WINDOW + MNV2_TIMED,
                                        MNV2_TIMED, fq, FQ_KERNELS + TRACED_KERNELS)
    for i, counts in enumerate(cap["per_step_launches"]):
        want = MNV2_QUANTIZERS // 2 if i < 2 else 0
        if (any(counts[k] != want for k in TRACED_KERNELS)
                or any(counts[k] for k in FQ_KERNELS)):
            raise AssertionError(f"captured step {i + 1}: launches {counts}")
    _graph_of(step)
    p = cap["profile"] = _profile_train_step(torch, step, spare, cap["step_ms"])
    cap["replay_fq_kernels"] = _fq_kinds(p["fq_kernels"])
    want_kinds = {"fwd/traced": MNV2_QUANTIZERS, "bwd_pt/traced": MNV2_QUANTIZERS // 2,
                  "bwd_pc/traced": MNV2_QUANTIZERS // 2}
    if cap["replay_fq_kernels"] != want_kinds:
        # the profiler can lose a few kernel records (profiler_check.py): the
        # larger count of two profiles a kind (a lost record only lowers one)
        again = _fq_kinds(_profile_train_step(torch, step, spare, cap["step_ms"])["fq_kernels"])
        cap["replay_fq_kernels"] = {k: max(cap["replay_fq_kernels"].get(k, 0), again.get(k, 0))
                                    for k in {**cap["replay_fq_kernels"], **again}}
    out.update({"eager": {k: v for k, v in eager.items() if k != "per_step_launches"},
                "captured": {k: v for k, v in cap.items() if k != "per_step_launches"},
                "eager_launches_a_step": eager["per_step_launches"][-1],
                "captured_launches_warmup_capture": cap["per_step_launches"][:2]})
    log(f"[convnet] mobilenetv2_cifar B={MNV2_B}, combo1200 (window {MNV2_WINDOW}), "
        f"AdamW cosine: eager {eager['images_per_s']:.1f} images/s "
        f"({eager['step_ms']:.2f} ms a step over steps {MNV2_WINDOW + 1}-"
        f"{eager['steps']}), captured {cap['images_per_s']:.1f} images/s "
        f"({cap['step_ms']:.2f} ms a replay over steps {MNV2_WINDOW + 1}-{cap['steps']}); "
        f"eager launches a step {eager['per_step_launches'][-1]}")
    log(f"[convnet] profiled replay: kernels busy {p['device_ms']:.2f} ms "
        f"({100 * p['busy_share']:.1f}% of a replay), {p['kernels']} kernels; by "
        "category: " + "; ".join(f"{k} {v:.2f} ms" for k, v in sorted(
            p["by_category_ms"].items(), key=lambda kv: -kv[1]))
        + f"; fake-quant kernels by kind {cap['replay_fq_kernels']}")
    if cap["replay_fq_kernels"] != want_kinds:
        raise AssertionError(f"the replay ran fake-quant kernels "
                             f"{cap['replay_fq_kernels']}, not {want_kinds}")

    # BatchNorm re-estimation: only the BatchNorm statistics move
    before = _quantizer_state(model)
    stats = {n: m.mean.clone() for n, m in model.named_modules()
             if isinstance(m, BatchNorm)}
    g = torch.Generator(device="cuda").manual_seed(777)
    reestimate_batch_stats(model, (make_batch(MNV2_B, g, "cuda")[0]
                                   for _ in range(MNV2_BN_BATCHES)))
    after = _quantizer_state(model)
    same = all(torch.equal(after[k], v) for k, v in before.items())
    moved = sum(not torch.equal(m.mean, stats[n]) for n, m in model.named_modules()
                if n in stats)
    out["bn_reestimation"] = {"batches": MNV2_BN_BATCHES, "quantizer_tensors": len(before),
                              "unchanged": same, "batchnorms_moved": moved,
                              "batchnorms": len(stats)}
    log(f"[convnet] reestimate_batch_stats over {MNV2_BN_BATCHES} batches: "
        f"{len(before)} quantizer tensors unchanged: {same}; BatchNorm means moved "
        f"{moved} of {len(stats)}")
    if not (same and moved == len(stats)):
        raise AssertionError(f"BN re-estimation: {out['bn_reestimation']}")

    # convert and serve at w8a8 (the captured leg's model) and w4a8
    images = make_batch(MNV2_EVAL_N, torch.Generator(device="cuda").manual_seed(99),
                        "cuda")[0]
    out["serve_w8a8"] = _mnv2_serve(torch, model, 8, images, mm, fq)
    w4 = _mnv2(torch, "cuda", wbits=4)
    opt4 = _adamw(torch, w4)
    step4 = make_train_step(w4, opt4, jit=True)
    for i, batch in enumerate(_grating_batches(torch, MNV2_WINDOW + 2, MNV2_B, seed=41)):
        for group in opt4.param_groups:
            group["lr"] = cosine_lr(i, MNV2_PROTOCOL_STEPS)
        step4(batch)
    out["serve_w4a8"] = _mnv2_serve(torch, w4, 4, images, mm, fq)
    out["launches"] = {k: fq[k] for k in FQ_KERNELS + TRACED_KERNELS}
    out["launches"].update({k: mm[k] for k in ("wo8", "wo4")})
    log(f"[convnet] launches on the path: {out['launches']}")
    missing = [k for k, v in out["launches"].items() if not v]
    if missing:
        raise AssertionError(f"kernels of the conv-net path never launched: {missing}")
    del w4, opt4, step4, step

    # one B = 8 step from the eager leg's state on the card and on the CPU
    out["cpu_check"] = _cpu_check(
        torch, eager_model, make_train_step(eager_model, _sgd(torch, eager_model), jit=False),
        _grating_batches(torch, 1, CHECK_B, seed=51)[0], lambda: _mnv2(torch, "cpu"),
        f"[convnet] B={CHECK_B}")
    del eager_model, model

    # eager = captured from one state (cuDNN deterministic), across the window's
    # end (a 2-batch window here), the cosine lr on the card
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        models = [_mnv2(torch, "cuda", window=2) for _ in range(2)]
        opts = [_adamw(torch, m) for m in models]
        sched = lambda i: cosine_lr(i, EQUAL_STEPS + 1)  # noqa: E731
        n_leaves, losses, unequal = _steps_equal(
            torch, models, opts, _grating_batches(torch, EQUAL_STEPS, MNV2_B, seed=61),
            schedule=sched)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    out["captured_vs_eager"] = {"steps": EQUAL_STEPS, "leaves": n_leaves,
                                "losses": losses, "unequal": unequal}
    worst = max((u["rel"] for u in unequal), default=0.0)
    log(f"[convnet] eager vs captured step from one state, cuDNN deterministic, "
        f"{EQUAL_STEPS} steps (window end at 3), capturable AdamW under the cosine lr: "
        f"{n_leaves} leaves a step, {len(unequal)} not bit-equal {unequal[:5]}")
    if not worst <= 1e-6:
        raise AssertionError(f"mobilenetv2: the captured step left another state than "
                             f"the eager step: {unequal[:10]}")
    del models, opts
    out["classifier_kernels"] = _classifier_kernels(torch, rec)
    out["wall_s"] = time.time() - t0
    log(f"[convnet] phase 13 took {out['wall_s']:.1f} s")


# ---------------------------------------------------------------------------
# the expensive observers: MSE, percentile and histogram on mobilenetv2_cifar
# ---------------------------------------------------------------------------

def _mnv2_obs(torch, device, kind, window=MNV2_WINDOW):
    """Full-width mobilenetv2_cifar under ``default_qconfig(8, 8,
    per_channel_weights=True, act_observer=kind)`` with a ``window``-batch
    observer window (examples/recipe_sweep.py's mse and histogram recipes:
    20 batches, the 7-bit activation range)."""
    from jaxlsq_torch.models import default_qconfig, mobilenetv2_cifar

    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=window,
                         act_observer=kind)
    return mobilenetv2_cifar(MNV2_CLASSES, qc, device=device, seed=0)


def _qat_adamw(torch, model):
    """``qat_optimizer`` over AdamW (weight decay 1e-4, ``capturable=True``)
    and the quantizer SGD (momentum 0.9, fused), each lr a tensor on the card
    (a captured step reads it there; an eager step given a Python float
    takes torch.optim's other arithmetic for it)."""
    from jaxlsq_torch.parallel import qat_optimizer

    return qat_optimizer(
        model,
        lambda ps: torch.optim.AdamW(ps, lr=torch.tensor(3e-3, device="cuda"),
                                     weight_decay=1e-4, capturable=True),
        lambda ps: torch.optim.SGD(ps, lr=torch.tensor(0.01, device="cuda"),
                                   momentum=0.9, fused=True))


def _obs_input(torch, shape, seed):
    """ReLU-like values with a few far outliers (a ragged case)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.relu(torch.randn(shape, device="cuda", generator=g))
    flat = x.view(-1)
    idx = torch.randint(0, flat.numel(), (max(1, flat.numel() // 4000),), device="cuda",
                        generator=g)
    flat[idx] = 12.0 + 4 * torch.rand(idx.numel(), device="cuda", generator=g)
    return x


def _check_mse(torch, x, spec, per_channel):
    """``mse_range`` against ``mse_range_plain`` on the card: the same
    candidate, or one whose plain error is within 1e-5 of the least; the same
    bits on a rerun; the gate false leaves every output untouched.  Returns
    the largest relative excess of a chosen candidate's plain error and the
    count of candidates that differ from the plain choice."""
    from jaxlsq_torch.ops.observers import linspace, mse_range, mse_range_plain

    if per_channel:
        red = tuple(a for a in range(x.dim()) if a != 1)
        bmin, bmax = x.amin(dim=red), x.amax(dim=red)
    else:
        bmin, bmax = x.amin().reshape(1), x.amax().reshape(1)
    c = bmin.numel()
    runs = []
    for _ in range(2):
        errs = torch.empty(c, 64, device="cuda")
        best = torch.empty(c, dtype=torch.int32, device="cuda")
        out = mse_range(x, bmin, bmax, spec, per_channel, 1, errs=errs, best=best)
        runs.append((out[0].clone(), out[1].clone(), errs, best))
    _, _, perrs, pbest = mse_range_plain(x, bmin, bmax, spec, per_channel, 1)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])):
        raise AssertionError(f"mse_range {tuple(x.shape)}: a rerun gave other bits")
    kbest = runs[0][3].long()
    picked = perrs.gather(1, kbest[:, None])[:, 0]
    least = perrs.min(dim=1).values
    excess = ((picked - least) / least.clamp_min(1e-30)).double()
    ok = (kbest == pbest) | (excess <= 1e-5)
    # every candidate's error: sums in another order; one element at another
    # level moves a small tensor's error by far more
    rel = ((runs[0][2] - perrs).abs() / perrs.abs().clamp_min(1e-30)).max()
    if not float(rel) <= 1e-3:
        raise AssertionError(f"mse_range {tuple(x.shape)}: errors {float(rel)} off the plain")
    if not bool(ok.all()):
        raise AssertionError(f"mse_range {tuple(x.shape)}: candidates {kbest.tolist()} "
                             f"against the plain {pbest.tolist()} (excess {excess.max()})")
    gate = torch.zeros((), dtype=torch.bool, device="cuda")
    sentinel = [torch.full((c,), -7.0, device="cuda"), torch.full((c,), -9.0, device="cuda")]
    errs = torch.full((c, 64), 3.0, device="cuda")
    best = torch.full((c,), 5, dtype=torch.int32, device="cuda")
    mse_range(x, bmin, bmax, spec, per_channel, 1, gate=gate, out=sentinel, errs=errs,
              best=best)
    torch.cuda.synchronize()
    if not bool((sentinel[0] == -7).all() and (sentinel[1] == -9).all()
                and (errs == 3).all() and (best == 5).all()):
        raise AssertionError(f"mse_range {tuple(x.shape)}: the gate off wrote an output")
    err = float((runs[0][0] - bmin * linspace(1 / 64, 1.0, 64).to(x.device)[pbest])
                .abs().max())
    return float(excess.max()), int((kbest != pbest).sum()), err


def _check_hist(torch, x1, x2, iters_out):
    """``hist_update`` (x1 into a fresh histogram, then x2, which widens the
    range) and ``hist_search`` on both histograms, against the plain versions
    on the CPU: the fresh histogram's integer counts exact, the widened
    one's bins within 1e-6 of the mass, the same chosen range (and trips);
    the same bits on a rerun; the gate false leaves every output untouched.
    Returns the bins' largest error over the mass."""
    from jaxlsq_torch.observers import HistogramObserver
    from jaxlsq_torch.ops.observers import (hist_search, hist_search_plain, hist_update,
                                            hist_update_plain)

    obs = HistogramObserver()
    st = obs.init(1, "cuda")
    worst = 0.0
    hists = []
    for x in (x1, x2):
        nmin = torch.where(st.seen == 0, x.amin().reshape(1),
                           torch.minimum(st.min_val, x.amin().reshape(1)))
        nmax = torch.where(st.seen == 0, x.amax().reshape(1),
                           torch.maximum(st.max_val, x.amax().reshape(1)))
        got = [hist_update(x, st.histogram, st.min_val, st.max_val, nmin, nmax, st.seen)
               for _ in range(2)]
        want = hist_update_plain(x.cpu(), st.histogram.cpu(), st.min_val.cpu(),
                                 st.max_val.cpu(), nmin.cpu(), nmax.cpu(), st.seen.cpu())
        torch.cuda.synchronize()
        if not torch.equal(got[0], got[1]):
            raise AssertionError(f"hist_update {tuple(x.shape)}: a rerun gave other bits")
        mass = max(float(want.sum()), 1.0)
        err = float((got[0].cpu() - want).abs().max()) / mass
        worst = max(worst, err)
        # into a fresh histogram both count in integers: exact
        if not (torch.equal(got[0].cpu(), want) if not hists else err <= 1e-6):
            raise AssertionError(f"hist_update {tuple(x.shape)}: bins {err} of the mass off")
        st = st.replace(min_val=nmin, max_val=nmax, histogram=got[0], seen=st.seen + 1)
        hists.append(st)
    for h in hists:
        iters = torch.zeros(2, dtype=torch.int32, device="cuda")
        rng = [hist_search(h.histogram, h.min_val, h.max_val, 256, iters=iters)
               for _ in range(2)]
        prng, counts = hist_search_plain(h.histogram.cpu(), h.min_val.cpu(),
                                         h.max_val.cpu(), 256)
        torch.cuda.synchronize()
        if not (torch.equal(rng[0], rng[1]) and torch.equal(rng[0].cpu(), prng)
                and tuple(iters.tolist()) == counts):
            raise AssertionError(f"hist_search {tuple(x1.shape)}: {rng[0].tolist()} "
                                 f"{iters.tolist()} against the plain {prng.tolist()} {counts}")
        iters_out.append(counts)
    gate = torch.zeros((), dtype=torch.bool, device="cuda")
    out = torch.full((2048,), -1.0, device="cuda")
    h = hists[0]
    hist_update(x2, h.histogram, h.min_val, h.max_val, hists[1].min_val, hists[1].max_val,
                h.seen, gate=gate, out=out)
    rout = torch.full((2,), -2.0, device="cuda")
    iters = torch.full((2,), -3, dtype=torch.int32, device="cuda")
    hist_search(h.histogram, h.min_val, h.max_val, 256, gate=gate, out=rout, iters=iters)
    torch.cuda.synchronize()
    if not bool((out == -1).all() and (rout == -2).all() and (iters == -3).all()):
        raise AssertionError("hist kernels: the gate off wrote an output")
    return worst


def _time_obs_kernels(torch, acts, spec):
    """Device ms of K1 (per tensor), K2 and K3 at each activation shape,
    their plain versions' ms at the largest shape, and each shape's bound."""
    from jaxlsq_torch.observers import HistogramObserver
    from jaxlsq_torch.ops.observers import (hist_search, hist_search_plain, hist_update,
                                            hist_update_plain, mse_range, mse_range_plain)

    rows = []
    for x in acts:
        n = x.numel()
        bmin, bmax = x.amin().reshape(1), x.amax().reshape(1)
        sets = [(x.clone(), bmin, bmax) for _ in range(copies_for(4 * n, 120e6))]
        k1, _ = measure(lambda a, lo, hi: mse_range(a, lo, hi, spec), sets, reps=10)
        st = HistogramObserver().init(1, "cuda")
        st = HistogramObserver().update(st, x)
        nmin, nmax = st.min_val * 1.25, st.max_val * 1.25
        k2, _ = measure(lambda a: hist_update(a, st.histogram, st.min_val, st.max_val,
                                              nmin, nmax, st.seen),
                        [(a,) for a, _, _ in sets], reps=10)
        iters = torch.zeros(2, dtype=torch.int32, device="cuda")
        k3, _ = measure(lambda h: hist_search(h, st.min_val, st.max_val, 256, iters=iters),
                        [(st.histogram,)], reps=5)
        trips, scored = iters.tolist()
        # K1: per element and candidate a divide, an add, max, min, rint, sub,
        # mul, sub, mul, add; K2: ~8 operations an element; K3: ~45 a bin a
        # scored trip, two binary searches a trip
        rows.append({"shape": list(x.shape), "elements": n, "mse_range_ms": k1,
                     "hist_update_ms": k2, "hist_search_ms": k3,
                     "hist_search_trips": trips, "hist_search_scored": scored,
                     "bounds": {"mse_range": bound(4 * n + 16, 640 * n),
                                "hist_update": bound(4 * n + 16 * 2048, 8 * n),
                                "hist_search": bound(8 * 2048 + 16,
                                                     45 * 2048 * scored + 66 * trips)}})
    big = max(acts, key=lambda t: t.numel())
    bmin, bmax = big.amin().reshape(1), big.amax().reshape(1)
    plain = {}
    plain["mse_range"], _ = measure(lambda a: mse_range_plain(a, bmin, bmax, spec),
                                    [(big,)], reps=2)
    st = HistogramObserver().update(HistogramObserver().init(1, "cuda"), big)
    nmin, nmax = st.min_val * 1.25, st.max_val * 1.25
    plain["hist_update"], _ = measure(
        lambda a: hist_update_plain(a, st.histogram, st.min_val, st.max_val, nmin, nmax,
                                    st.seen), [(big,)], reps=3)
    h, lo, hi = st.histogram.cpu(), st.min_val.cpu(), st.max_val.cpu()
    t0 = time.perf_counter()
    hist_search_plain(h, lo, hi, 256)
    plain["hist_search"] = 1e3 * (time.perf_counter() - t0)
    # the library yardstick of K2: torch.histc's batch counts alone into
    # 2,048 bins over the widened range (no fold of the old histogram);
    # K1 and K3 have no one-call counterpart
    lo_f, hi_f = float(nmin), float(nmax)
    sets = [(big.clone(),) for _ in range(copies_for(4 * big.numel(), 120e6))]
    library = {"hist_update": measure(lambda a: torch.histc(a, bins=2048, min=lo_f, max=hi_f),
                                      sets, reps=10)[0]}
    return rows, plain, library


def _obs_leg(torch, kind, steps, obs):
    """``steps`` captured steps of a fresh mobilenetv2 under ``kind`` and
    ``qat_optimizer``: the model, the step, a spare batch, the launches a
    step and the ms a replay in the window (steps 3 to the window's end)."""
    from jaxlsq_torch.lab.accuracy_parity import cosine_lr
    from jaxlsq_torch.parallel import make_train_step

    model = _mnv2_obs(torch, "cuda", kind)
    opt = _qat_adamw(torch, model)
    step = make_train_step(model, opt, jit=True)
    batches = _grating_batches(torch, steps + 1, MNV2_B, seed=71)
    per_step, losses = [], []
    torch.cuda.synchronize()
    t0 = None
    for i, batch in enumerate(batches[:steps]):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if i == MNV2_WINDOW:
            torch.cuda.synchronize()
            window_ms = 1e3 * (time.perf_counter() - t0) / (MNV2_WINDOW - 2)
        for group in opt.param_groups:
            group["lr"] = cosine_lr(i, MNV2_PROTOCOL_STEPS)
        before = dict(obs)
        losses.append(step(batch)["loss"])
        per_step.append({k: obs[k] - before[k] for k in OBS_KERNELS})
    torch.cuda.synchronize()
    losses = torch.stack(losses).cpu().tolist()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite mobilenetv2 loss under {kind}: {losses}")
    _graph_of(step)
    return model, step, batches[steps], {"per_step": per_step, "window_replay_ms": window_ms,
                                         "losses": losses}


def phase_observers(torch, rec):
    """The expensive observers on full-width mobilenetv2_cifar at B = 128
    (phase 14): K1-K3 against their plain versions at its 23 activation
    shapes on one step's real data and at ragged sizes; the captured step
    under each observer and the min/max one across the window's end (the
    launches, a post-window replay's ms beside the min/max config's, in
    turns); eager = captured; calibrate, convert and serve; a B = 8 step
    against the CPU."""
    from jaxlsq_torch.core.spec import QuantSpec
    from jaxlsq_torch.lab.accuracy_parity import cosine_lr, make_batch
    from jaxlsq_torch.models import calibrate, toggles
    from jaxlsq_torch.ops.observers import LAUNCHES as OBS
    from jaxlsq_torch.parallel import make_train_step

    t0 = time.time()
    out = rec["observers"] = {}
    spec = QuantSpec.activation_default(8, reduce_range=True)
    # K1-K3 on one eager step's real activations and at ragged sizes
    caps = _capture_quantizers(torch, _mnv2_obs(torch, "cuda", "minmax"),
                               _grating_batches(torch, 1, MNV2_B, 81)[0])
    acts = [c["x"] for c in caps if c["name"].endswith("act_fq")]
    del caps
    if len(acts) != MNV2_QUANTIZERS // 2:
        raise AssertionError(f"{len(acts)} activation quantizers, not {MNV2_QUANTIZERS // 2}")
    ragged = [_obs_input(torch, shape, seed=i) for i, shape in enumerate(OBS_RAGGED)]
    checks = {"mse_pt_excess": 0.0, "mse_pc_excess": 0.0, "mse_other_candidate": 0,
              "mse_err": 0.0, "hist_mass_err": 0.0, "search_trips": []}
    for i, x in enumerate(acts + ragged):
        for pc in (False, True):
            ex, other, err = _check_mse(torch, x if x.dim() == 4 or not pc else
                                        x.reshape(1, 1, -1), spec, pc)
            key = "mse_pc_excess" if pc else "mse_pt_excess"
            checks[key] = max(checks[key], ex)
            checks["mse_other_candidate"] += other
            if not pc:
                checks["mse_err"] = max(checks["mse_err"], err)
        # a second batch that widens the range both ways
        checks["hist_mass_err"] = max(checks["hist_mass_err"], _check_hist(
            torch, x, x * 1.3 - 0.2, checks["search_trips"]))
    for k, v in (("mse_range", checks["mse_err"]), ("hist_update", checks["hist_mass_err"]),
                 ("hist_search", 0.0)):
        rec["max_abs_err"][k] = v
    out["checks"] = checks
    trips = [t for t, _ in checks["search_trips"][:2 * len(acts)]]
    log(f"[observers] K1-K3 against their plain versions at mobilenetv2_cifar's "
        f"{len(acts)} activation shapes (one step's real data) and {len(ragged)} ragged "
        f"sizes: mse_range per tensor and per channel, the chosen candidate's plain "
        f"error at most {checks['mse_pt_excess']:.2e} / {checks['mse_pc_excess']:.2e} "
        f"above the least ({checks['mse_other_candidate']} other candidates, tol 1e-5); "
        f"hist_update's fresh counts exact and widened bins within "
        f"{checks['hist_mass_err']:.2e} of the mass (tol 1e-6), "
        f"hist_search the plain range and trips exactly (trips {min(trips)}-{max(trips)}"
        f" on the real activations); every kernel the same bits on a rerun and silent "
        "with the gate off")

    # times at the real shapes
    rows, plain, library = _time_obs_kernels(torch, acts, spec)
    big = max(rows, key=lambda r: r["elements"])
    out["times"] = {"rows": rows, "plain_ms_largest": plain, "largest": big["shape"],
                    "library_ms_largest": library,
                    "sum_ms": {k: sum(r[k + "_ms"] for r in rows) for k in OBS_KERNELS},
                    "sum_bound_ms": {k: sum(r["bounds"][k][0] for r in rows)
                                     for k in OBS_KERNELS}}
    log(f"[observers] at {big['shape']}: mse_range {1e3 * big['mse_range_ms']:.1f} us "
        f"(bound {1e3 * big['bounds']['mse_range'][0]:.1f}, {big['bounds']['mse_range'][1]}"
        f"), hist_update {1e3 * big['hist_update_ms']:.1f} us (bound "
        f"{1e3 * big['bounds']['hist_update'][0]:.1f}), hist_search "
        f"{1e3 * big['hist_search_ms']:.1f} us ({big['hist_search_trips']} trips, "
        f"{big['hist_search_scored']} scored); over the 23 shapes "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in out["times"]["sum_ms"].items())
        + f"; plain at the largest: {plain}; torch.histc (2,048 bins, the batch's counts "
        f"alone) {1e3 * library['hist_update']:.1f} us")

    # the main path, every count reset: the captured step under each config
    reset_counts()
    legs = {}
    for kind in ("minmax",) + OBS_KINDS:
        model, step, spare, leg = _obs_leg(torch, kind, MNV2_WINDOW + 4, OBS)
        legs[kind] = (model, step, spare, leg)
    out["launches"] = dict(OBS)
    for kind, (_, _, _, leg) in legs.items():
        want = {"minmax": {}, "percentile": {}, "mse": {"mse_range": 23},
                "histogram": {"hist_update": 23, "hist_search": 23}}[kind]
        for i, counts in enumerate(leg["per_step"]):
            for k in OBS_KERNELS:
                w = want.get(k, 0) if i < 2 else 0
                if counts[k] != w:
                    raise AssertionError(f"{kind} captured step {i + 1}: {k} ran "
                                         f"{counts[k]} times, not {w}")
    # a post-window replay of each config, in turns, the min of two rounds
    order = ("minmax",) + OBS_KINDS
    replay = {k: [] for k in order}
    for kinds in (order, order[::-1]):
        for kind in kinds:
            _, step, spare, _ = legs[kind]
            span, _ = events_ms(lambda: [step(spare) for _ in range(OBS_TIMED)])
            replay[kind].append(span / OBS_TIMED)
    post = {k: min(v) for k, v in replay.items()}
    out["replay_ms"] = {"post_window": post, "rounds": replay,
                        "window": {k: legs[k][3]["window_replay_ms"] for k in order}}
    log("[observers] captured mobilenetv2 B=128 under qat_optimizer(AdamW): a replay in "
        "the window (steps 3-20) " + ", ".join(
            f"{k} {legs[k][3]['window_replay_ms']:.2f} ms" for k in order)
        + "; past the window (min of 2 rounds of " + str(OBS_TIMED) + ") " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in post.items())
        + f"; launches {out['launches']}")
    if not post["mse"] <= 1.05 * post["minmax"]:
        raise AssertionError(f"the MSE config's post-window replay {post['mse']:.3f} ms is "
                             f"more than 5% over the min/max one's {post['minmax']:.3f} ms")
    missing = [k for k, v in out["launches"].items() if not v]
    if missing:
        raise AssertionError(f"observer kernels never launched on the path: {missing}")
    del legs, model, step, spare

    # eager = captured from one state over 5 steps across a 2-batch window
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    out["captured_vs_eager"] = {}
    try:
        for kind in OBS_KINDS:
            models = [_mnv2_obs(torch, "cuda", kind, window=2) for _ in range(2)]
            opts = [_qat_adamw(torch, m) for m in models]
            per_step = []
            n_leaves, losses, unequal = _steps_equal(
                torch, models, opts, _grating_batches(torch, EQUAL_STEPS, MNV2_B, seed=91),
                schedule=lambda i: cosine_lr(i, EQUAL_STEPS + 1), counts=OBS,
                per_step=per_step)
            out["captured_vs_eager"][kind] = {"leaves": n_leaves, "losses": losses,
                                              "unequal": unequal, "launches": per_step}
            worst = max((u["rel"] for u in unequal), default=0.0)
            log(f"[observers] {kind}: eager vs captured from one state, {EQUAL_STEPS} steps "
                f"across a 2-batch window: {n_leaves} leaves a step, {len(unequal)} not "
                f"bit-equal {unequal[:3]}; launches a step "
                + str([{k: v for k, v in r.items() if k in OBS_KERNELS} for r in per_step]))
            if not worst <= 1e-6:
                raise AssertionError(f"{kind}: the captured step left another state")
            del models, opts
    finally:
        cudnn.deterministic, cudnn.benchmark = saved

    # calibrate over 20 batches, then convert and serve at w8a8
    images = make_batch(MNV2_EVAL_N, torch.Generator(device="cuda").manual_seed(99),
                        "cuda")[0]
    mm, _, fq = reset_counts()
    out["calibrate_serve"] = {}
    for kind in OBS_KINDS:
        model = _mnv2_obs(torch, "cuda", kind)
        g = torch.Generator(device="cuda").manual_seed(101)
        before = dict(OBS)
        calibrate(model, [make_batch(MNV2_B, g, "cuda")[0] for _ in range(MNV2_BN_BATCHES)])
        toggles.disable_observer(model)  # the eval logits use the calibrated qparams
        served = _mnv2_serve(torch, model, 8, images, mm, fq)
        served["calibrate_launches"] = {k: OBS[k] - before[k] for k in OBS_KERNELS}
        out["calibrate_serve"][kind] = served
        del model
    # one B = 8 step on the card and on the CPU plain path, in the window
    out["cpu_check"] = {}
    for kind in OBS_KINDS:
        model = _mnv2_obs(torch, "cuda", kind)
        out["cpu_check"][kind] = _cpu_check(
            torch, model, make_train_step(model, _sgd(torch, model), jit=False),
            _grating_batches(torch, 1, CHECK_B, seed=111)[0],
            lambda kind=kind: _mnv2_obs(torch, "cpu", kind), f"[observers] {kind} B={CHECK_B}")
        del model
    out["wall_s"] = time.time() - t0
    log(f"[observers] phase 14 took {out['wall_s']:.1f} s")


# ---------------------------------------------------------------------------
# third-party models: a stock ResNet-18 swapped by quantize_model
# ---------------------------------------------------------------------------

def _stock(torch, seed=0, device="cuda"):
    """A full-width StockResNet18 (torch.nn only, 10 classes) from ``seed``."""
    from jaxlsq_torch.lab.stock_resnet import stock_resnet18

    return stock_resnet18(10, seed=seed).to(device)


def _stock_qc(wbits=8):
    """__graft_entry__.py's qconfig (per-channel weights), a 2-batch window."""
    from jaxlsq_torch.models import default_qconfig

    return default_qconfig(wbits, 8, per_channel_weights=True, init_batches=STOCK_WINDOW)


def _swap(torch, stock, device="cuda", wbits=8, serve=False):
    from jaxlsq_torch.models import quantize_model

    qc = _stock_qc(wbits)
    return quantize_model(stock, qc.for_serving("static") if serve else qc, device=device)


def _train_leg(torch, step, batches, fq, kernels, skip=STOCK_WINDOW):
    """``step`` over ``batches``: ms a step and images/s past the first
    ``skip`` steps, the losses, the launches of ``kernels`` a step."""
    torch.cuda.synchronize()
    losses, per_step, t_start = [], [], None
    for i, batch in enumerate(batches):
        if i == skip:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        before = dict(fq)
        losses.append(step(batch)["loss"])
        per_step.append({k: fq[k] - before[k] for k in kernels})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    timed = len(batches) - skip
    leg = {"steps": len(batches), "step_ms": 1e3 * wall / timed,
           "images_per_s": timed * batches[0]["image"].shape[0] / wall,
           "losses": torch.stack(losses).cpu().tolist(), "per_step_launches": per_step}
    if not all(math.isfinite(v) for v in leg["losses"]):
        raise AssertionError(f"non-finite training loss: {leg['losses']}")
    return leg


def _categories(p):
    return "; ".join(f"{k} {v:.2f} ms" for k, v in sorted(p["by_category_ms"].items(),
                                                        key=lambda kv: -kv[1]))


def _stock_serve(torch, model, stock, wbits, images, mm, fq):
    """``qat_variables`` of the QAT ``model`` through ``convert`` into
    ``quantize_model(stock, qc.for_serving('static'))`` (``load_variables``):
    its logits on ``images`` within 1e-4 of max|ref| of the QAT model's eval
    logits, the head through wo8/wo4 by the counts and by the profiler, and
    no fake-quant launch."""
    from jaxlsq_torch import interop
    from jaxlsq_torch.models import QuantDense
    from jaxlsq_torch.parallel import make_eval_step
    from jaxlsq_torch.serve import convert

    served = _swap(torch, stock, wbits=wbits, serve=True)
    interop.load_variables(served, convert(interop.qat_variables(model), _stock_qc(wbits)))
    served.eval()
    if not isinstance(served.head, QuantDense):
        raise AssertionError("the served head is not a packed layer")
    want = make_eval_step(model)({"image": images})
    before_mm, before_fq = dict(mm), dict(fq)
    with torch.no_grad():
        got = served(images)
        torch.cuda.synchronize()
        launches = {k: mm[k] - before_mm[k] for k in mm}
        fq_launches = sum(fq[k] - before_fq[k] for k in fq)
        rows, _ = device_profile(lambda: served(images), f"the served w{wbits}a8 forward",
                                 sleep_ms=20)
    wo_rows = {e.key[:60]: e.count for e in rows if "wo_mma" in e.key}
    err = float((got - want).abs().max())
    tol = 1e-4 * float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    kernel = "wo8" if wbits == 8 else "wo4"
    out = {"logits_err": err, "tol": tol, "top1_agreement": agree, "launches": launches,
           "fake_quant_launches": fq_launches, "profiled_wo_kernels": wo_rows}
    log(f"[third-party] served w{wbits}a8 stock resnet18 on {images.shape[0]} images: "
        f"logits vs the QAT model's eval logits max_abs_err {err:.3e} (tol {tol:.3e}), "
        f"argmax agreement {agree:.4f}; launches {launches}; the profiler's wo kernels "
        f"{wo_rows}")
    if not (err <= tol and bool(torch.isfinite(got).all())):
        raise AssertionError(f"w{wbits}a8 served logits disagree: {err} > {tol}")
    if launches[kernel] != 1 or fq_launches or sum(wo_rows.values()) != 1:
        raise AssertionError(f"w{wbits}a8: the served head ran {launches}, the profiler "
                             f"saw {wo_rows}, {fq_launches} fake-quant launches")
    return out


def phase_third_party(torch, rec):
    """Third-party models: a full-width stock ResNet-18 (``lab/stock_resnet.py``,
    torch.nn only) through ``quantize_model`` at B = 64: the fake-quant kernels
    at its quantizer shapes against their plain versions; the swap; eager and
    captured QAT across the window beside phases 6-7's hand-built resnet, a
    B = 8 step against the CPU plain path, eager = captured; distillation from
    the float stock model; checkpoint and resume; convert and serve at w8a8
    and w4a8; BN re-estimation of the stock BatchNorms."""
    import tempfile

    from torch import nn

    from jaxlsq_torch.models.quantize import QuantConv2d, QuantLinear
    from jaxlsq_torch.parallel import distillation_loss, make_eval_step, make_train_step
    from jaxlsq_torch.utils import reestimate_batch_stats, restore_or_init, save_checkpoint

    t0 = time.time()
    out = rec["third_party"] = {}
    stock = _stock(torch)
    # the kernels at the swapped model's 42 quantizer shapes (the head's (10, 512)
    # weight per channel on axis 0 among them), one eager step's real data
    caps = _capture_quantizers(torch, _swap(torch, stock),
                               _image_batches(torch, 1, TRAIN_B, seed=11)[0])
    if len(caps) != 2 * STOCK_SWAPPED:
        raise AssertionError(f"captured {len(caps)} quantizers, expected "
                             f"{2 * STOCK_SWAPPED} with gradients")
    errs = {k: 0.0 for k in FQ_KERNELS + TRACED_KERNELS + FUSED_KERNELS}
    worst = {False: 0.0, True: 0.0}
    for c in caps:
        for traced in (False, True):
            worst[traced] = max(worst[traced], _check_fq(
                torch, c["x"], c["scale"], c["shift"], c["g"], c["spec"], errs,
                f"stock resnet18 {c['name']}", traced))
    for k, v in errs.items():
        rec["max_abs_err"][k] = max(rec["max_abs_err"][k], v)
    out["fq_shapes"] = [{"name": c["name"], "shape": list(c["x"].shape),
                         "per_channel": c["spec"].per_channel,
                         "axis": c["spec"].axis if c["spec"].per_channel else None}
                        for c in caps]
    head = [r for r in out["fq_shapes"] if r["name"] == "head.weight_fq"]
    if [(r["shape"], r["axis"]) for r in head] != [([10, 512], 0)]:
        raise AssertionError(f"the head's weight quantizer was captured as {head}")
    log(f"[third-party] fake-quant kernels at the swapped stock resnet18's {len(caps)} "
        f"quantizer shapes at B={TRAIN_B} (the head's weight {head[0]['shape']} per channel "
        "on axis 0), one eager step's real data, static and traced: forward and dX "
        f"bit-exact; dS/dB worst {worst[False]:.2e} / {worst[True]:.2e} of their term "
        "sums (tol 1e-5)")
    del caps

    mm, _, fq = reset_counts()
    # (a) the swap: 21 layers, the stock names and layouts, the stock untouched
    stock_sd = {k: v.clone() for k, v in stock.state_dict().items()}
    model = _swap(torch, stock)
    swapped = [n for n, m in model.named_modules() if isinstance(m, (QuantConv2d, QuantLinear))]
    keys = [k for k in model.state_dict() if "_fq." not in k]
    res = _swap(torch, stock).load_state_dict(stock.state_dict(), strict=False)
    out["swap"] = {"swapped": len(swapped), "stock_keys_kept": keys == list(stock_sd),
                   "missing_quantizer_keys": len(res.missing_keys),
                   "unexpected": list(res.unexpected_keys)}
    log(f"[third-party] quantize_model(StockResNet18): {out['swap']}")
    if (len(swapped) != STOCK_SWAPPED or keys != list(stock_sd) or res.unexpected_keys
            or not res.missing_keys or not all("_fq." in k for k in res.missing_keys)):
        raise AssertionError(f"the swap went wrong: {out['swap']}")

    # (b) eager and captured QAT at B = 64 across the window
    batches = _image_batches(torch, TRAIN_STEPS + 1, TRAIN_B, seed=3)
    step = make_train_step(model, _sgd(torch, model), jit=False)
    eager = _train_leg(torch, step, batches[:TRAIN_STEPS], fq, FQ_KERNELS)
    for i, counts in enumerate(eager["per_step_launches"]):
        for k, v in counts.items():
            want = STOCK_SWAPPED - (k == "fq_bwd_pt" and i < STOCK_WINDOW)
            if v != want:
                raise AssertionError(f"eager step {i + 1}: {k} ran {v} times, not {want}")
    eager["profile"] = _profile_train_step(torch, step, batches[TRAIN_STEPS], eager["step_ms"])
    out["cpu_check"] = _cpu_check(
        torch, model, step, _image_batches(torch, 1, CHECK_B, seed=5)[0],
        lambda: _swap(torch, _stock(torch, device="cpu"), device="cpu"),
        f"[third-party] B={CHECK_B}")
    del model, step
    cmodel = _swap(torch, stock)
    cstep = make_train_step(cmodel, _sgd(torch, cmodel), jit=True)
    cap = _train_leg(torch, cstep, batches[:TRAIN_STEPS], fq, FQ_KERNELS + TRACED_KERNELS)
    for i, counts in enumerate(cap["per_step_launches"]):
        want = STOCK_SWAPPED if i < 2 else 0
        if any(counts[k] != want for k in TRACED_KERNELS) or any(counts[k] for k in FQ_KERNELS):
            raise AssertionError(f"captured step {i + 1}: launches {counts}")
    _graph_of(cstep)
    p = cap["profile"] = _profile_train_step(torch, cstep, batches[TRAIN_STEPS], cap["step_ms"])
    kinds = cap["replay_fq_kernels"] = _fq_kinds(p["fq_kernels"])
    want_kinds = {"fwd/traced": 2 * STOCK_SWAPPED, "bwd_pt/traced": STOCK_SWAPPED,
                  "bwd_pc/traced": STOCK_SWAPPED}
    bn_shapes = []
    hooks = [m.register_forward_hook(lambda mod, i, o: bn_shapes.append(tuple(i[0].shape)))
             for m in cmodel.modules() if isinstance(m, nn.BatchNorm2d)]
    make_eval_step(cmodel)(batches[0])  # keeps no state
    for h in hooks:
        h.remove()
    bn = _batchnorm_ms(torch, bn_shapes,
                       make=lambda c: nn.BatchNorm2d(c).to("cuda"))
    hand_e, hand_c = rec["train"], rec["train_captured"]
    out.update({"eager": {k: v for k, v in eager.items() if k != "per_step_launches"},
                "captured": {k: v for k, v in cap.items() if k != "per_step_launches"},
                "eager_launches_a_step": eager["per_step_launches"][-1],
                "batchnorm": bn, "hand_built": {
                    "eager_step_ms": hand_e["step_ms"], "replay_ms": hand_c["step_ms"],
                    "eager_kernels": hand_e["profile"]["kernels"],
                    "replay_kernels": hand_c["profile"]["kernels"],
                    "eager_by_category_ms": hand_e["profile"]["by_category_ms"],
                    "replay_by_category_ms": hand_c["profile"]["by_category_ms"],
                    "batchnorm": hand_e["batchnorm"]}})
    log(f"[third-party] stock resnet18 B={TRAIN_B}: eager {eager['step_ms']:.2f} ms a step "
        f"(hand-built resnet18_cifar, phase 6: {hand_e['step_ms']:.2f}), a replay "
        f"{cap['step_ms']:.2f} ms (phase 7: {hand_c['step_ms']:.2f}); losses "
        + " ".join(f"{v:.4f}" for v in cap["losses"]))
    log(f"[third-party] profiled eager step: {eager['profile']['kernels']} kernels, "
        f"{eager['profile']['device_ms']:.2f} ms busy: {_categories(eager['profile'])}; "
        f"hand-built: {hand_e['profile']['kernels']} kernels: {_categories(hand_e['profile'])}")
    log(f"[third-party] profiled replay: {p['kernels']} kernels, {p['device_ms']:.2f} ms "
        f"busy ({100 * p['busy_share']:.1f}%): {_categories(p)}; hand-built: "
        f"{hand_c['profile']['kernels']} kernels: {_categories(hand_c['profile'])}; "
        f"fake-quant kinds {kinds}")
    log(f"[third-party] the {len(bn_shapes)} stock BatchNorm2d layers alone (cuDNN), forward "
        f"+ backward at B={TRAIN_B}: {bn['ms']:.2f} ms on the device, {bn['kernels']} "
        f"kernels; the port's flax-rule BatchNorm at the same shapes (phase 6): "
        f"{hand_e['batchnorm']['ms']:.2f} ms, {hand_e['batchnorm']['kernels']} kernels")
    if kinds != want_kinds:
        raise AssertionError(f"the replay ran fake-quant kernels {kinds}, not {want_kinds}")

    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        models = [_swap(torch, stock) for _ in range(2)]
        n_leaves, losses, unequal = _steps_equal(
            torch, models, [_sgd(torch, m) for m in models],
            _image_batches(torch, EQUAL_STEPS, TRAIN_B, seed=7))
        out["captured_vs_eager"] = {"steps": EQUAL_STEPS, "leaves": n_leaves,
                                    "losses": losses, "unequal": unequal}
        log(f"[third-party] eager vs captured step from one state, cuDNN deterministic, "
            f"{EQUAL_STEPS} steps (window end at 3): {n_leaves} leaves a step, "
            f"{len(unequal)} not bit-equal {unequal[:5]}")
        if not max((u["rel"] for u in unequal), default=0.0) <= 1e-6:
            raise AssertionError(f"the captured step left another state than the eager "
                                 f"step: {unequal[:10]}")
        del models

        # (d) checkpoint at step k, restore_or_init a fresh model and optimizer,
        # capture, m more steps: the uninterrupted run's k + m in every leaf
        cb = _image_batches(torch, CKPT_K + CKPT_M, TRAIN_B, seed=13)
        umodel = _swap(torch, stock)
        uopt = _sgd(torch, umodel)
        ustep = make_train_step(umodel, uopt, jit=True)
        with tempfile.TemporaryDirectory() as d:
            for i, b in enumerate(cb):
                if i == CKPT_K:
                    save_checkpoint(d, {"model": umodel, "optimizer": uopt}, CKPT_K)
                ustep(b)

            def init():
                m = _swap(torch, _stock(torch, seed=1))
                return {"model": m, "optimizer": _sgd(torch, m)}

            state, got = restore_or_init(d, init)
        rstep = make_train_step(state["model"], state["optimizer"], jit=True)
        for b in cb[CKPT_K:]:
            rstep(b)
        want_state = _train_state(umodel, uopt)
        got_state = _train_state(state["model"], state["optimizer"])
        diff = sorted(k for k in want_state if k not in got_state
                      or not torch.equal(want_state[k], got_state[k]))
        out["checkpoint"] = {"k": CKPT_K, "m": CKPT_M, "restored_step": got,
                             "leaves": len(want_state), "unequal": diff}
        log(f"[third-party] checkpoint at step {CKPT_K}, restore_or_init (step {got}) into a "
            f"fresh model and optimizer, captured, {CKPT_M} more steps: {len(want_state)} "
            f"leaves, {len(diff)} unlike the uninterrupted run's {diff[:5]}")
        if got != CKPT_K or diff or len(got_state) != len(want_state):
            raise AssertionError(f"the resumed run differs: {out['checkpoint']}")
        del umodel, uopt, ustep, state, rstep
    finally:
        cudnn.deterministic, cudnn.benchmark = saved

    # (c) distillation from the float stock model, captured
    teacher = stock.eval()
    dmodel = _swap(torch, stock)
    dstep = make_train_step(dmodel, _sgd(torch, dmodel), jit=True,
                            loss_fn=distillation_loss(teacher, alpha=0.5, temperature=2.0))
    dleg = _train_leg(torch, dstep, _image_batches(torch, STOCK_DISTILL_STEPS, TRAIN_B, 17),
                      fq, ())
    cpu_teacher = _stock(torch, device="cpu").eval()
    dcheck = _cpu_check(
        torch, dmodel, dstep, _image_batches(torch, 1, CHECK_B, seed=19)[0],
        lambda: _swap(torch, _stock(torch, device="cpu"), device="cpu"),
        f"[third-party] distilled B={CHECK_B}",
        cpu_loss_fn=lambda: distillation_loss(cpu_teacher, alpha=0.5, temperature=2.0))
    changed = [k for k, v in stock.state_dict().items() if not torch.equal(v, stock_sd[k])]
    out["distill"] = {"step_ms": dleg["step_ms"], "replay_ms": cap["step_ms"],
                      "overhead_ms": dleg["step_ms"] - cap["step_ms"],
                      "losses": dleg["losses"], "cpu_check": dcheck,
                      "teacher_changed": changed}
    log(f"[third-party] distillation_loss(stock.eval(), alpha=0.5, T=2), captured: "
        f"{dleg['step_ms']:.2f} ms a replay against {cap['step_ms']:.2f} without "
        f"(+{dleg['step_ms'] - cap['step_ms']:.2f} ms: the teacher's forward); teacher "
        f"leaves changed: {changed}")
    if changed:
        raise AssertionError(f"the teacher changed: {changed}")
    del dmodel, dstep

    # (e) convert and serve at w8a8 (the captured leg's model) and w4a8
    images = torch.randn(STOCK_EVAL_N, 3, 32, 32, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(99))
    out["serve_w8a8"] = _stock_serve(torch, cmodel, stock, 8, images, mm, fq)
    m4 = _swap(torch, stock, wbits=4)
    step4 = make_train_step(m4, _sgd(torch, m4), jit=True)
    for b in _image_batches(torch, STOCK_WINDOW + 2, TRAIN_B, seed=41):
        step4(b)
    out["serve_w4a8"] = _stock_serve(torch, m4, stock, 4, images, mm, fq)
    del m4, step4

    # BN re-estimation: the stock BatchNorm statistics move, no quantizer tensor
    before = _quantizer_state(cmodel)
    bns = {n: m.running_mean.clone() for n, m in cmodel.named_modules()
           if isinstance(m, nn.BatchNorm2d)}
    reestimate_batch_stats(cmodel, (b["image"] for b in _image_batches(torch, 20, TRAIN_B, 23)))
    after = _quantizer_state(cmodel)
    same = all(torch.equal(v, after[k]) for k, v in before.items())
    moved = sum(not torch.equal(m.running_mean, bns[n]) for n, m in cmodel.named_modules()
                if n in bns)
    out["bn_reestimation"] = {"quantizer_tensors": len(before), "unchanged": same,
                              "batchnorms_moved": moved, "batchnorms": len(bns)}
    log(f"[third-party] reestimate_batch_stats over 20 batches: {out['bn_reestimation']}")
    if not (same and moved == len(bns)):
        raise AssertionError(f"BN re-estimation: {out['bn_reestimation']}")

    out["launches"] = {k: fq[k] for k in FQ_KERNELS + TRACED_KERNELS}
    out["launches"].update({k: mm[k] for k in ("wo8", "wo4")})
    log(f"[third-party] launches on the path: {out['launches']}")
    missing = [k for k, v in out["launches"].items() if not v]
    if missing:
        raise AssertionError(f"kernels of the third-party path never launched: {missing}")
    out["wall_s"] = time.time() - t0
    log(f"[third-party] phase 15 took {out['wall_s']:.1f} s")


# ---------------------------------------------------------------------------
# phase 16: decode features
# ---------------------------------------------------------------------------

def _decode_rows(torch, model, seq, t0, take=None):
    """Prefill ``seq[:, :t0]``, then one-token decode steps over the rest:
    the (B, len - t0 + 1, V) logits of positions t0 - 1 .. len - 1, and each
    activation quantizer's outputs over positions 0 .. len - 2 (B, len - 1,
    K).  With ``take`` (such outputs of a reference run), an output more than
    half a quant step from the reference's takes the reference's value,
    after checking they differ by at most one step (and the two levels' f32
    rounding); returns ``(logits, outputs, [taken, elements])``."""
    from jaxlsq_torch.serve import prefill

    cur, moved, acts = [0, 0], [0, 0], {}

    def hook(n, mod, inp, out):
        if take is not None:
            ref = take[n][:, cur[0]:cur[1]].to(out.device)
            d = (ref - out).abs()
            q = float(mod.scale.detach().abs().max())
            slack = 1e-5 * q + 2 * F32_EPS * float(out.abs().max())
            if float(d.max()) > q + slack:
                raise AssertionError(f"[decode] {n}: activations differ by "
                                     f"{float(d.max())}, more than a quant step {q}")
            far = d > 0.5 * q
            moved[0] += int(far.sum())
            moved[1] += out.numel()
            out = torch.where(far, ref, out)
        acts.setdefault(n, []).append(out.detach().cpu())
        return out

    hooks = [m.register_forward_hook(lambda mod, i, o, n=n: hook(n, mod, i, o))
             for n, m in _act_quantizers(model)]
    try:
        cur[:] = [0, t0]
        last, cache, idx = prefill(model, seq[:, :t0])
        rows = [last]
        with torch.no_grad():
            for t in range(t0, seq.shape[1]):
                cur[:] = [t, t + 1]
                logits, cache = model(seq[:, t:t + 1], cache=cache, cache_index=t)
                rows.append(logits[:, 0])
    finally:
        for h in hooks:
            h.remove()
    return (torch.stack(rows, 1), {n: torch.cat(v, 1) for n, v in acts.items()}, moved)


def _qat_decode(torch, model, prompt, n_new, what):
    """A QAT-mode LM (observers off) through the cache branch: ``make_generate``
    leaves every quantizer parameter and buffer bit-identical; the decoded
    logits over prompt + tokens lie within 1e-4 of max|ref| of the full eval
    forward's, and of the same decode on the CPU plain path.  The decode's
    matmuls run at other row counts than the full forward's (and the CPU's
    in another order), so an activation can round to the neighbouring level:
    there the decode takes the full forward's activation (the CPU the
    card's), and at most ``MAX_DECODE_MOVED`` of the elements may move."""
    from jaxlsq_torch import interop
    from jaxlsq_torch.models import QuantTransformerLM, disable_observer
    from jaxlsq_torch.models.layers import quant_state_frozen
    from jaxlsq_torch.serve import make_generate

    disable_observer(model)
    t0 = prompt.shape[1]
    before = _quantizer_state(model)
    toks = make_generate(model, t0, n_new)(prompt)
    changed = [k for k, v in _quantizer_state(model).items() if not torch.equal(v, before[k])]
    if changed:
        raise AssertionError(f"[decode] {what}: make_generate changed {changed[:4]}")
    seq = torch.cat([prompt, toks[:, :-1].to(prompt.dtype)], 1)
    full_acts = {}
    hooks = [m.register_forward_hook(
        lambda mod, i, o, n=n: full_acts.__setitem__(n, o.detach().cpu()))
        for n, m in _act_quantizers(model)]
    model.eval()
    try:
        with torch.no_grad(), quant_state_frozen(list(model.modules())):
            full = model(seq)[:, t0 - 1:]
    finally:
        model.train()
        for h in hooks:
            h.remove()
    dec, dec_acts, moved = _decode_rows(torch, model, seq, t0, take=full_acts)
    cpu = QuantTransformerLM(model.vocab, model.dim, model.depth, model.num_heads,
                             model.qconfig, max_len=model.max_len,
                             pos_embedding=model.pos_embedding, device="cpu")
    interop.load_qat_variables(cpu, interop.qat_variables(model))
    disable_observer(cpu)
    dec_cpu, _, moved_cpu = _decode_rows(torch, cpu, seq.cpu(), t0, take=dec_acts)
    out = {"tokens": n_new, "quantizer_tensors_unchanged": len(before)}
    for name, ref, mv in (("full_forward", full, moved), ("cpu", dec_cpu, moved_cpu)):
        err = float((dec.cpu() - ref.cpu()).abs().max())
        tol = 1e-4 * float(ref.abs().max())
        out[f"logits_err_vs_{name}"], out[f"tol_vs_{name}"] = err, tol
        out[f"moved_vs_{name}"] = mv
        if not (err <= tol and torch.isfinite(dec).all()):
            raise AssertionError(f"[decode] {what}: decoded logits vs {name} {err} > {tol} "
                                 f"({mv[0]} of {mv[1]} activations handed over)")
        if mv[0] > MAX_DECODE_MOVED * mv[1]:
            raise AssertionError(f"[decode] {what}: {mv[0]} of {mv[1]} activations "
                                 f"handed over against the {name}")
    log(f"[decode] QAT decode of the {what}: {n_new} tokens through the cache branch; "
        f"logits vs the full eval forward max_abs_err {out['logits_err_vs_full_forward']:.3e}"
        f" (tol {out['tol_vs_full_forward']:.3e}; {moved[0]} of {moved[1]} activations "
        f"handed over), vs the CPU {out['logits_err_vs_cpu']:.3e} (tol "
        f"{out['tol_vs_cpu']:.3e}; {moved_cpu[0]} handed over); {len(before)} quantizer "
        f"tensors bit-identical after make_generate")
    return out


def _first_divergence(torch, model, run_a, run_b):
    """The first module (in call order) whose outputs differ between two runs
    of the same positions: ``run_a`` one token a call, ``run_b`` all at
    once; the outputs of ``run_a``'s calls are joined along t."""
    outs = {"a": {}, "b": {}}
    order = []
    side = ["a"]

    def hook(name):
        def fn(mod, args, out):
            if torch.is_tensor(out) and out.dim() >= 3:
                if name not in order:
                    order.append(name)
                outs[side[0]].setdefault(name, []).append(out.detach())
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n]
    try:
        run_a()
        side[0] = "b"
        run_b()
    finally:
        for h in handles:
            h.remove()
    for name in order:
        a, b = outs["a"].get(name), outs["b"].get(name)
        if not a or not b:
            continue
        b = b[-1]
        t = b.shape[1]
        if len(a) < t or any(x.shape[1] != 1 for x in a[-t:]):
            continue
        a = torch.cat(a[-t:], 1)
        if a.shape == b.shape and not torch.equal(a, b):
            return name, float((a - b).abs().max())
    return None, 0.0


def _verify_rows_equal(torch, model, seq, k, starts):
    """The speculative verify (one forward over k + 1 rows at position p)
    gives, row for row, the bits of the t = 1 decode steps at p .. p + k, on
    the same cache contents (a prefill of ``seq[:, :p]``)."""
    from jaxlsq_torch.serve import prefill

    for p in starts:
        def steps():
            _, cache, _ = prefill(model, seq[:, :p])
            rows = []
            with torch.no_grad():
                for j in range(k + 1):
                    logits, cache = model(seq[:, p + j:p + j + 1], cache=cache,
                                          cache_index=p + j)
                    rows.append(logits[:, 0])
            return torch.stack(rows, 1)

        def verify():
            _, cache, _ = prefill(model, seq[:, :p])
            with torch.no_grad():
                return model(seq[:, p:p + k + 1], cache=cache, cache_index=p)[0]

        a, b = steps(), verify()
        if not torch.equal(a, b):
            where, diff = _first_divergence(torch, model, steps, verify)
            raise AssertionError(
                f"[decode] verify rows at position {p} differ from the t=1 decode "
                f"steps' (max {float((a - b).abs().max()):.3e}); first differing "
                f"module: {where} ({diff:.3e})")
    return len(starts)


def _spec_kernels(torch, run, rounds):
    """Kernels a round from the profiles' kernel counts of ``run(n)`` at the
    two lengths of ``rounds`` (the larger of two profiles each), over the
    rounds between."""
    def count(n):
        return max(sum(e.count for e in profiled(lambda: run(n))[0]) for _ in range(2))

    (n1, r1), (n2, r2) = sorted(rounds.items())
    return (count(n2) - count(n1)) / (r2 - r1)


def _speculative(torch, st, sd, prompt, card):
    """Plain greedy against speculative greedy (k = 4) at B = 1 on the served
    pair: tokens equal bit for bit, the verify rows equal the t = 1 steps'
    bits, tokens/s from the 16 -> 208 slope, kernels and host reads a round;
    sampled speculative decoding, and the target as its own draft."""
    from jaxlsq_torch.serve import make_generate, make_speculative_generate

    lengths = (SPEC_N1, SPEC_N_PROFILED, SPEC_N2)
    plain = {n: make_generate(st, SPEC_T0, n) for n in lengths}
    spec = {n: make_speculative_generate(st, sd, SPEC_T0, n, k=SPEC_K, return_stats=True)
            for n in lengths}
    want = plain[SPEC_N2](prompt)
    got, stats = spec[SPEC_N2](prompt)
    if not torch.equal(got, want):
        raise AssertionError(f"[decode] speculative greedy != greedy: {got} vs {want}")
    seq = torch.cat([prompt, want.to(prompt.dtype)], 1)
    checked = _verify_rows_equal(torch, st, seq, SPEC_K, (SPEC_T0, SPEC_T0 + 41, SPEC_T0 + 150))
    rounds = {n: spec[n](prompt)[1]["rounds"] for n in (SPEC_N1, SPEC_N_PROFILED)}
    t = {"plain": ([], []), "spec": ([], [])}
    for _ in range(2):
        for name, fns in (("plain", plain), ("spec", spec)):
            for i, n in enumerate((SPEC_N1, SPEC_N2)):
                s = time.perf_counter()
                r = fns[n](prompt)
                (r[0] if isinstance(r, tuple) else r).cpu()
                t[name][i].append(time.perf_counter() - s)
    tps = {name: (SPEC_N2 - SPEC_N1) / (min(t2) - min(t1)) for name, (t1, t2) in t.items()}
    k_round = _spec_kernels(torch, lambda n: spec[n](prompt), rounds)
    k_token = _spec_kernels(torch, lambda n: plain[n](prompt),
                            {SPEC_N1: SPEC_N1, SPEC_N_PROFILED: SPEC_N_PROFILED})
    out = {"tokens_equal": True, "verify_positions_bit_equal": checked,
           "accepted_per_round_greedy": stats["accepted_per_round"],
           "rounds": stats["rounds"], "host_reads_per_round": stats["host_reads"] / stats["rounds"],
           "plain_tokens_per_s": tps["plain"], "spec_tokens_per_s": tps["spec"],
           "speedup": tps["spec"] / tps["plain"], "kernels_per_round": k_round,
           "plain_kernels_per_token": k_token, "raw_s": t}
    log(f"[decode] speculative greedy (k={SPEC_K}) = plain greedy bit for bit over {SPEC_N2} "
        f"tokens; verify rows = t=1 rows bit for bit at {checked} positions; accepted "
        f"{stats['accepted_per_round']:.3f} a round; plain {tps['plain']:.1f} tokens/s, "
        f"speculative {tps['spec']:.1f} ({out['speedup']:.2f}x; slope {SPEC_N1}->{SPEC_N2}); "
        f"{k_round:.1f} kernels and {out['host_reads_per_round']:.0f} host read a round, "
        f"plain {k_token:.1f} kernels a token ({card})")
    gen = torch.Generator(device="cuda")
    sampled = make_speculative_generate(st, sd, SPEC_T0, SPEC_N2, k=SPEC_K,
                                        temperature=SPEC_TEMP, return_stats=True)
    toks, sst = sampled(prompt, gen.manual_seed(7))
    if toks.shape != (1, SPEC_N2) or not ((toks >= 0) & (toks < st.vocab)).all():
        raise AssertionError(f"[decode] sampled speculative: bad tokens {toks.shape}")
    self_spec = make_speculative_generate(st, st, SPEC_T0, SPEC_N1, k=SPEC_K,
                                          temperature=SPEC_TEMP, return_stats=True)
    _, self_st = self_spec(prompt, gen.manual_seed(8))
    if self_st["accepted_per_round"] != SPEC_K + 1:
        raise AssertionError(f"[decode] the target as its own sampled draft accepted "
                             f"{self_st['accepted_per_round']} a round, not {SPEC_K + 1}")
    out.update(accepted_per_round_sampled=sst["accepted_per_round"],
               sampled_temperature=SPEC_TEMP,
               self_draft_sampled_accepted_per_round=self_st["accepted_per_round"])
    log(f"[decode] speculative sampling T={SPEC_TEMP}: {SPEC_N2} tokens in range, "
        f"accepted {sst['accepted_per_round']:.3f} a round; the target as its own "
        f"draft accepts {self_st['accepted_per_round']:.0f} = k + 1")
    return out


def _spec_engines(torch, st, sd, prompts, card):
    """SpeculativeDecodeEngine and PagedSpeculativeDecodeEngine (max_batch 8,
    bf16 caches; page 16, a pool of SPEC_PAGES) over 16 staggered requests,
    8 on a registered 40-token prefix: every request equals its own B = 1
    greedy ``make_generate``, paged equals dense, the paged run defers and
    shares prefix pages."""
    import numpy as np

    from jaxlsq_torch.serve import (PagedSpeculativeDecodeEngine, SpeculativeDecodeEngine,
                                    make_generate)

    r = np.random.RandomState(16)
    rows = prompts.cpu().numpy()
    prefix = rows[0, :40]
    reqs = [(rows[1 + i, :int(r.randint(4, 33))], int(r.randint(16, 49)), i % 2 == 1)
            for i in range(SPEC_REQUESTS)]
    dt = torch.bfloat16
    want = []
    for p, n, shared in reqs:
        full = np.concatenate([prefix, p]) if shared else p
        want.append(make_generate(st, len(full), n, cache_dtype=dt)(
            torch.as_tensor(full, device="cuda")[None])[0].cpu().numpy())
    out = {}
    for name, make in (
            ("dense", lambda: SpeculativeDecodeEngine(
                st, sd, max_batch=8, prompt_buckets=(8, 32), k=SPEC_K, cache_dtype=dt)),
            ("paged", lambda: PagedSpeculativeDecodeEngine(
                st, sd, num_pages=SPEC_PAGES, page_size=SPEC_PAGE, max_batch=8,
                prompt_buckets=(8, 32), k=SPEC_K, cache_dtype=dt))):
        with make() as eng:
            eng.warmup()
            h = eng.register_prefix(prefix)
            s = time.perf_counter()
            futs = []
            for i, (p, n, shared) in enumerate(reqs):
                futs.append(eng.submit(p, n, prefix=h if shared else None))
                if i % 4 == 3:
                    time.sleep(0.005)
            outs = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - s
            stats = dict(eng.stats)
        for i, (got, w) in enumerate(zip(outs, want)):
            if not np.array_equal(got, w):
                raise AssertionError(f"[decode] {name} speculative engine request {i}: "
                                     f"{got} != make_generate's {w}")
        n_tok = sum(len(o) for o in outs)
        out[name] = {"outs": outs, "wall_s": wall, "tokens_per_s": n_tok / wall,
                     "rounds": stats["rounds"], "accepted_tokens": stats["accepted_tokens"],
                     **{k: stats[k] for k in ("admissions_deferred", "prefix_pages_shared")
                        if k in stats}}
        log(f"[decode] {name} SpeculativeDecodeEngine: {len(reqs)} requests, {n_tok} "
            f"tokens in {wall:.3f} s ({n_tok / wall:.1f} tokens/s), {stats['rounds']} "
            f"rounds; every request = make_generate at B=1"
            + (f"; {stats['admissions_deferred']} deferrals, "
               f"{stats['prefix_pages_shared']} prefix pages shared" if name == "paged"
               else "") + f" ({card})")
    if any(not np.array_equal(a, b) for a, b in zip(out["dense"].pop("outs"),
                                                    out["paged"].pop("outs"))):
        raise AssertionError("[decode] the paged speculative engine differs from the dense")
    if out["paged"]["admissions_deferred"] < 1 or out["paged"]["prefix_pages_shared"] < 1:
        raise AssertionError(f"[decode] the paged run neither deferred nor shared: {out['paged']}")
    return out


def _rescore(torch, model, prompt, toks, eos):
    """Joint log-prob of ``toks`` after ``prompt`` under one teacher-forced
    full forward (up to and including the first eos when ``eos`` is set)."""
    seq = torch.cat([prompt, toks.to(prompt.dtype)], 1)
    with torch.no_grad():
        logp = torch.log_softmax(model(seq)[:, prompt.shape[1] - 1:-1], -1)
    lp = torch.gather(logp, 2, toks.long()[..., None])[..., 0]
    if eos is not None:
        is_eos = (toks == eos).to(torch.int32)
        first = torch.where(is_eos.any(1), is_eos.argmax(1), toks.shape[1] - 1)
        lp = torch.where(torch.arange(toks.shape[1], device=toks.device)[None] <= first[:, None],
                         lp, 0.0)
    return lp.sum(1)


def _beam(torch, card):
    """make_beam_search on phase 3's d1024 x 4 LM (vocab 8192) and its w4
    twin: beams=1 equals make_generate (B = 8, bf16 and int8 caches); beams=4
    at B = 1 and 8, eos unset and set (f32 cache): the best sequence's score
    within 1e-4·max(1, |score|) of one teacher-forced full forward's; the B = 1
    tokens against the CPU plain run's; tokens/s from the 16 -> 80 slope."""
    import numpy as np

    from jaxlsq_torch import interop
    from jaxlsq_torch.models import QuantTransformerLM
    from jaxlsq_torch.serve import make_beam_search, make_generate

    r = np.random.RandomState(18)
    out = {"beam1_equal": [], "beam4": {}}
    models = {w: _lm(torch, w, T0 + 80, seed=w)[:2] for w in (8, 4)}
    prompt8 = torch.as_tensor(r.randint(0, VOCAB, size=(8, T0)), device="cuda")
    for w, (model, _) in models.items():
        for cdt in (torch.bfloat16, torch.int8):
            toks, scores = make_beam_search(model, T0, 8, beams=1, cache_dtype=cdt)(prompt8)
            want = make_generate(model, T0, 8, cache_dtype=cdt)(prompt8)
            if not torch.equal(toks, want) or not torch.isfinite(scores).all():
                raise AssertionError(f"[decode] beams=1 != greedy (w{w}, {cdt})")
            out["beam1_equal"].append(f"w{w} {cdt}")
    model, variables = models[8]
    eos = int(make_generate(model, T0, 8)(prompt8[:1])[0, 3])  # a token greedy emits
    for b in (1, 8):
        prompt = prompt8[:b]
        for e in (None, eos):
            toks, scores = make_beam_search(model, T0, 16, beams=BEAMS, eos_id=e)(prompt)
            ref = _rescore(torch, model, prompt, toks, e)
            err = float(((scores - ref).abs() / scores.abs().clamp(min=1.0)).max())
            if not err <= 1e-4:
                raise AssertionError(f"[decode] beam-{BEAMS} B={b} eos={e}: scores "
                                     f"{scores.tolist()} vs rescored {ref.tolist()}")
            out["beam4"][f"b{b}_eos{e}"] = {"scores": scores.tolist(), "rel_err": err}
    # the B = 1 search on the CPU plain path
    cpu = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, model.qconfig, max_len=T0 + 80,
                             device="cpu")
    interop.load_variables(cpu, _to_cpu(torch, variables))
    n_cpu = 4
    got, gs = make_beam_search(model, T0, n_cpu, beams=BEAMS)(prompt8[:1])
    want, ws = make_beam_search(cpu, T0, n_cpu, beams=BEAMS)(prompt8[:1].cpu())
    tie = None
    if not torch.equal(got.cpu(), want):
        # a tie the sum order broke the other way: both sequences' joint
        # log-probs, on the CPU, within 1e-4 of each other
        a = float(_rescore(torch, cpu, prompt8[:1].cpu(), got.cpu(), None)[0])
        b_ = float(_rescore(torch, cpu, prompt8[:1].cpu(), want, None)[0])
        tie = {"card": got.tolist(), "cpu": want.tolist(), "scores_cpu": [a, b_]}
        log(f"[decode] beam-{BEAMS} tokens differ from the CPU's: {tie}")
        if not abs(a - b_) <= 1e-4 * max(1.0, abs(b_)):
            raise AssertionError(f"[decode] beam-{BEAMS} tokens differ from the CPU "
                                 f"plain run's and no tie: {tie}")
    out["cpu"] = {"tokens_equal": tie is None, "tie": tie,
                  "score_err": abs(float(gs[0]) - float(ws[0]))}
    tps = {}
    for b in (1, 8):
        fns = {n: make_beam_search(model, T0, n, beams=BEAMS) for n in (16, 80)}
        ts = {16: [], 80: []}
        fns[80](prompt8[:b])[0].cpu()
        for _ in range(2):
            for n in (16, 80):
                s = time.perf_counter()
                fns[n](prompt8[:b])[0].cpu()
                ts[n].append(time.perf_counter() - s)
        tps[b] = b * (80 - 16) / (min(ts[80]) - min(ts[16]))
    out["tokens_per_s"] = tps
    log(f"[decode] beam search: beams=1 = greedy for {out['beam1_equal']}; beam-{BEAMS} "
        f"scores = teacher-forced rescoring (max rel err "
        f"{max(v['rel_err'] for v in out['beam4'].values()):.2e}); B=1 tokens "
        + ("= the CPU plain run's" if tie is None else "a tie against the CPU's")
        + f"; beam-{BEAMS} {tps[1]:.1f} tokens/s at B=1, {tps[8]:.1f} at B=8 "
        f"(slope 16->80, B x new tokens) ({card})")
    return out


def _serving_engine(torch, card):
    """ServingEngine over a calibrated, converted full-width mobilenetv2_cifar
    at w8a8 (max_batch 64): 200 single-image requests in bursts, twice.  Each
    result equals, bit for bit, the eager forward of its padded bucket batch
    and lies within 1e-5 of max|ref| of a B = 1 call; pass 1 captures each
    bucket it uses once, ``warmup`` the rest, the timed passes none."""
    import numpy as np

    from jaxlsq_torch import interop
    from jaxlsq_torch.lab.accuracy_parity import make_batch
    from jaxlsq_torch.models import calibrate, mobilenetv2_cifar
    from jaxlsq_torch.serve import ServingEngine

    model = _mnv2(torch, "cuda", 8)
    g = torch.Generator(device="cuda").manual_seed(161)
    calibrate(model, [make_batch(MNV2_B, g, "cuda")[0] for _ in range(4)])
    served = mobilenetv2_cifar(MNV2_CLASSES, model.qconfig.for_serving("static"),
                               device="cuda")
    interop.load_variables(served, interop.qat_variables(model))
    served.eval()
    images = make_batch(ENGINE_REQUESTS, g, "cuda")[0].cpu().numpy()
    r = np.random.RandomState(162)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    passes = []
    try:
        with ServingEngine(served, images.shape[1:], max_batch=ENGINE_MAX_B) as eng:
            for k in range(ENGINE_PASSES):
                if k == 1:
                    eng.warmup()  # the buckets pass 1 did not use
                before = dict(eng.stats, batch_sizes=len(eng.stats["batch_sizes"]))
                caps = dict(eng.captures)
                s = time.perf_counter()
                futs, i = [], 0
                while i < ENGINE_REQUESTS:
                    n = int(r.randint(1, ENGINE_MAX_B + 1))
                    futs += eng.submit_many(list(images[i:i + n]))
                    i += n
                    time.sleep(0.002)
                res = [f.result(timeout=300) for f in futs]
                wall = time.perf_counter() - s
                sizes = list(eng.stats["batch_sizes"])[before["batch_sizes"]:]
                passes.append({"wall_s": wall, "requests_per_s": ENGINE_REQUESTS / wall,
                               "batches": len(sizes), "batch_sizes": sizes,
                               "padded_examples": eng.stats["padded_examples"]
                               - before["padded_examples"],
                               "captures": {b: eng.captures[b] - caps[b] for b in caps}})
                # each batch against the eager forward of its padded bucket
                j, worst = 0, 0.0
                for n in sizes:
                    b = eng._bucket_for(n)
                    x = np.zeros((b,) + images.shape[1:], np.float32)
                    x[:n] = images[j:j + n]
                    with torch.no_grad():
                        want = served(torch.as_tensor(x, device="cuda")).cpu().numpy()
                    got = np.stack(res[j:j + n])
                    if not np.array_equal(got, want[:n]):
                        raise AssertionError(f"[engine] a bucket-{b} batch differs from its "
                                             f"eager forward: {np.abs(got - want[:n]).max()}")
                    for q in range(j, j + n, 17):
                        with torch.no_grad():
                            one = served(torch.as_tensor(images[q:q + 1], device="cuda"))
                        one = one.cpu().numpy()[0]
                        worst = max(worst, float(np.abs(res[q] - one).max()
                                                 / np.abs(one).max()))
                    j += n
                if worst > 1e-5:
                    raise AssertionError(f"[engine] results vs a B=1 call: {worst} > 1e-5")
                passes[-1]["vs_b1_rel_err"] = worst
    finally:
        torch.backends.cudnn.deterministic = det
    used = {eng._bucket_for(n) for n in passes[0]["batch_sizes"]}
    if (any(passes[0]["captures"][b] != (b in used) for b in eng.buckets)
            or any(any(q["captures"].values()) for q in passes[1:])
            or any(v != 1 for v in eng.captures.values())):
        raise AssertionError(f"[engine] captures {[q['captures'] for q in passes]} by pass "
                             f"(buckets used in pass 1 {sorted(used)}), {eng.captures} in all")
    # a full bucket's replay (the input copy in, the output copy out) beside
    # the eager forward of the same batch
    x = torch.as_tensor(images[:ENGINE_MAX_B])
    rep = {}
    for name, run in (("replay", lambda: eng._forward(x)),
                      ("eager", lambda: served(x.to("cuda")).cpu())):
        ts = []
        with torch.no_grad():
            for _ in range(10):
                s = time.perf_counter()
                run()
                ts.append(time.perf_counter() - s)
        rep[f"{name}_ms"] = 1e3 * min(ts)
    best = max(passes[1:], key=lambda q: q["requests_per_s"])
    log(f"[engine] ServingEngine, w8a8 mobilenetv2_cifar, max_batch {ENGINE_MAX_B}: "
        f"{ENGINE_REQUESTS} requests a pass; timed passes "
        + ", ".join(f"{q['requests_per_s']:.1f}" for q in passes[1:])
        + f" requests/s ({best['batches']} batches, {best['padded_examples']} padded "
        f"examples in the best); a bucket-{ENGINE_MAX_B} replay {rep['replay_ms']:.2f} ms "
        f"beside its eager forward {rep['eager_ms']:.2f} ms; pass 1 captured the "
        f"buckets it used, {sorted(used)}, once each, warmup() the rest, later passes none; "
        f"every result = the eager forward of its padded batch bit for bit, within "
        f"{max(q['vs_b1_rel_err'] for q in passes):.1e} of max|ref| of a B=1 call ({card})")
    return {"passes": passes, "buckets_used": sorted(used), **rep}


def phase_decode_features(torch, rec):
    from jaxlsq_torch.lab import speculative_decode as lab
    from jaxlsq_torch.serve.paged import LAUNCHES as PAGED

    card = rec["card"]
    out = {}
    rec["decode_features"] = out
    t_start = time.time()
    mm, attn, fq = reset_counts()
    target, draft = lab.lm_pair(SPEC_MAXLEN, "cuda")
    s = time.time()
    out["target_loss"] = lab.train(target, SPEC_TARGET_STEPS, SPEC_B, seed=0)
    out["target_train_s"] = time.time() - s
    s = time.time()
    out["draft_loss"] = lab.train(draft, SPEC_DRAFT_STEPS, SPEC_B, seed=0)
    out["draft_train_s"] = time.time() - s
    out["train_steps"] = {"target": SPEC_TARGET_STEPS, "draft": SPEC_DRAFT_STEPS}
    log(f"[decode] trained the pair on the Markov corpus (B={SPEC_B}, captured steps): "
        f"target d1024x4 {SPEC_TARGET_STEPS} steps in {out['target_train_s']:.1f} s, "
        f"loss {out['target_loss']:.3f}; draft d128x1 {SPEC_DRAFT_STEPS} steps in "
        f"{out['draft_train_s']:.1f} s, loss {out['draft_loss']:.3f} (cut from 1200 each)")
    prompts = lab.corpus_batch(1 + SPEC_REQUESTS, torch.Generator(device="cuda").manual_seed(99),
                               "cuda")
    legs = out["leg_s"] = {"train": time.time() - t_start}
    s = time.time()
    out["qat_decode"] = _qat_decode(torch, target, prompts[:2, :SPEC_T0], 8,
                                    "trained d1024x4 target (per tensor)")
    lm = _lm_qat(torch, "cuda", "xla", seed=3)
    lm.eval()
    with torch.no_grad():  # one eval batch feeds the activation observers
        lm(torch.randint(0, LM_VOCAB, (2, 64), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(3)))
    lm.train()
    out["qat_decode_rope"] = _qat_decode(
        torch, lm, torch.randint(0, LM_VOCAB, (1, SPEC_T0), device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(4)),
        8, "d512x2 rope LM (per channel)")
    del lm
    legs["qat_decode"], s = time.time() - s, time.time()
    st, sd = lab.serve(target), lab.serve(draft)
    del target, draft
    out["speculative"] = _speculative(torch, st, sd, prompts[:1, :SPEC_T0], card)
    legs["speculative"], s = time.time() - s, time.time()
    out["engines"] = _spec_engines(torch, st, sd, prompts, card)
    legs["engines"], s = time.time() - s, time.time()
    del st, sd
    out["beam"] = _beam(torch, card)
    legs["beam"], s = time.time() - s, time.time()
    out["serving_engine"] = _serving_engine(torch, card)
    torch.cuda.synchronize()
    legs["serving_engine"] = time.time() - s
    out["launches"] = {**fq, **mm, **attn, **PAGED}
    out["wall_s"] = time.time() - t_start
    log(f"[decode] kernel launches on the decode-features path: {out['launches']}; "
        f"phase 16 took {out['wall_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in legs.items()) + ")")
    for k in ("fq_fwd_pt", "fq_fwd_pc", "wo8", "wo4", "decode_attention",
              "paged_attention"):
        if out["launches"][k] <= 0:
            raise AssertionError(f"kernel {k} was never launched on the decode-features path")


# ---------------------------------------------------------------------------
# phase 17: the int8 x int8 serving path and the quantized MoE


def _int8_pack(torch, shape, g, per_channel=True, affine=False):
    """A seeded int8 pack of a (K, N) weight or an HWIO conv kernel (per
    output channel) or an (E, K, N) stack (per expert); ``affine`` gives
    zero points off 0."""
    from jaxlsq_torch.core.spec import QuantSpec
    from jaxlsq_torch.serve.pack import quantize_weight

    axis = 0 if len(shape) == 3 else len(shape) - 1
    qmax = 127
    spec = QuantSpec(quant_min=-qmax - 1, quant_max=qmax, type_min=-qmax - 1, type_max=qmax,
                     per_channel=per_channel, axis=axis)
    w = torch.randn(shape, device="cuda", generator=g) * shape[-2] ** -0.5
    red = tuple(a for a in range(len(shape)) if a != axis)
    amax = w.abs().amax(red) if per_channel else w.abs().amax().reshape(1)
    scale = amax / (qmax * 0.9)
    shift = (torch.randn(scale.shape, device="cuda", generator=g) * scale * 9 if affine
             else torch.zeros_like(scale))
    return quantize_weight(w, scale, shift, spec, bits=8)


def _equal_twice(torch, fn, plain, what):
    """``fn()`` twice and ``plain()``: the same bits, or raise."""
    a, b, want = fn(), fn(), plain()
    torch.cuda.synchronize()
    for got in (a, b):
        got = got if isinstance(got, tuple) else (got,)
        ref = want if isinstance(want, tuple) else (want,)
        for x, y in zip(got, ref):
            if not _same_bits(torch, x, y):
                raise AssertionError(f"{what}: the kernel differs from its plain version "
                                     f"({float((x.double() - y.double()).abs().nan_to_num(1.0).max())})")


def _check_int8_kernels(torch, rec):
    """act_quant_i8 and i8mm against their plain versions on the card, bit for
    bit and the same bits on two runs: every (M, K, N) of INT8_MS x INT8_KS x
    INT8_NS with signed per-channel, unsigned (shifted) per-tensor and
    unsigned affine weights, the dynamic mode; NaN, +-inf and zeros; the
    experts' batched product (E = 8, per-expert qparams) at the MoE LM's
    shapes; mobilenetv2's stem, depthwise and 1 x 1 shapes with symmetric
    and affine weights.  Then the fake-quant kernels at the MoE LM's
    per-expert shapes (phase 2's gates)."""
    from jaxlsq_torch.models import default_qconfig
    from jaxlsq_torch.serve.matmul import (act_quant_i8, act_quant_i8_plain,
                                           dynamic_int8_matmul, dynamic_int8_matmul_plain,
                                           static_int8_bmm, static_int8_bmm_plain,
                                           static_int8_conv,
                                           static_int8_conv_plain, static_int8_matmul,
                                           static_int8_matmul_plain)

    t0 = time.time()
    g = torch.Generator(device="cuda").manual_seed(170)
    acts = {"signed": (-128, 127, -3), "unsigned": (0, 255, 131)}
    sx = torch.tensor([0.037], device="cuda")
    n_cases = 0
    for k in INT8_KS:
        for n in INT8_NS:
            packs = {"per_channel": _int8_pack(torch, (k, n), g),
                     "per_tensor": _int8_pack(torch, (k, n), g, per_channel=False),
                     "affine": _int8_pack(torch, (k, n), g, affine=True)}
            for m in INT8_MS:
                x = torch.randn(m, k, device="cuda", generator=g) * 2
                for wname, act in (("per_channel", "signed"), ("per_tensor", "unsigned"),
                                   ("affine", "unsigned"), ("affine", "signed")):
                    qmin, qmax, zp = acts[act]
                    z = torch.tensor([zp], dtype=torch.int32, device="cuda")
                    p = packs[wname]
                    _equal_twice(torch, lambda: static_int8_matmul(x, p, sx, z, qmin, qmax),
                                 lambda: static_int8_matmul_plain(x, p, sx, z, qmin, qmax),
                                 f"static_int8_matmul M={m} K={k} N={n} {wname} {act}")
                    n_cases += 1
                for wname in ("per_channel", "affine"):
                    p = packs[wname]
                    _equal_twice(torch, lambda: dynamic_int8_matmul(x, p),
                                 lambda: dynamic_int8_matmul_plain(x, p),
                                 f"dynamic_int8_matmul M={m} K={k} N={n} {wname}")
                    n_cases += 1
    for shape in ((1, 27), (17, 1000), (256, 4096), (8, 640, 1024)):
        x = torch.randn(shape, device="cuda", generator=g) * 3
        for special in (None, float("nan"), float("inf"), -float("inf"), 0.0):
            xs = x.clone()
            if special == 0.0:
                xs.zero_()
            elif special is not None:
                xs.view(-1)[7] = special
            for act in ("signed", "unsigned"):
                qmin, qmax, zp = acts[act]
                z = torch.tensor([zp], dtype=torch.int32, device="cuda")
                _equal_twice(torch, lambda: act_quant_i8(xs, sx, z, qmin, qmax),
                             lambda: act_quant_i8_plain(xs, sx, z, qmin, qmax),
                             f"act_quant_i8 {shape} {act} {special}")
            _equal_twice(torch, lambda: act_quant_i8(xs, dynamic=True),
                         lambda: act_quant_i8_plain(xs, dynamic=True),
                         f"act_quant_i8 {shape} dynamic {special}")
            n_cases += 3
    for (k, n), c in [(kn, c) for kn in ((DIM, 4 * DIM), (4 * DIM, DIM)) for c in (1, 37, 640)]:
        x = torch.randn(MOE_E, c, k, device="cuda", generator=g)
        for per_expert in (True, False):
            p = _int8_pack(torch, (MOE_E, k, n), g, per_channel=per_expert, affine=per_expert)
            z = torch.tensor([128], dtype=torch.int32, device="cuda")
            _equal_twice(torch,
                         lambda: static_int8_bmm(x, p.data, p.scale, p.zero_point, sx, z,
                                                 0, 255),
                         lambda: static_int8_bmm_plain(x, p.data, p.scale, p.zero_point, sx,
                                                       z, 0, 255),
                         f"static_int8_bmm E={MOE_E} C={c} K={k} N={n}")
            n_cases += 1
    convs = ((3, 32, 1, 3, 1, 32), (32, 32, 32, 3, 1, 32), (96, 96, 96, 3, 2, 32),
             (144, 144, 144, 3, 1, 8), (32, 16, 1, 1, 1, 32), (960, 320, 1, 1, 1, 4),
             (320, 1280, 1, 1, 1, 4))
    for cin, cout, groups, kk, stride, hw in convs:
        x = torch.randn(8, cin, hw, hw, device="cuda", generator=g)
        for affine in (False, True):
            p = _int8_pack(torch, (kk, kk, cin // groups, cout), g, affine=affine)
            z = torch.tensor([128], dtype=torch.int32, device="cuda")
            kw = dict(strides=(stride, stride), padding="SAME", feature_group_count=groups)
            _equal_twice(torch, lambda: static_int8_conv(x, p, sx, z, 0, 255, **kw),
                         lambda: static_int8_conv_plain(x, p, sx, z, 0, 255, **kw),
                         f"static_int8_conv {cin}->{cout} groups {groups} {kk}x{kk} "
                         f"stride {stride} {hw}x{hw} affine={affine}")
            n_cases += 1
    n_forms = _check_i8mm_forms(torch, g)
    n_cases += n_forms
    for k in INT8_KERNELS:
        rec["max_abs_err"][k] = 0.0
    # the fake-quant kernels at the per-expert shapes: the weight stacks on
    # axis 0 (8 channels of 4 Mi elements) and the expert activations
    qc = default_qconfig(8, 8, per_channel_weights=True)
    wspec = qc.weight_for_axis(0).spec
    aspec = qc.activation.spec
    worst = 0.0
    for shape, spec in (((MOE_E, DIM, 4 * DIM), wspec), ((MOE_E, 4 * DIM, DIM), wspec),
                        ((MOE_E, 640, DIM), aspec), ((MOE_E, 640, 4 * DIM), aspec)):
        x = torch.randn(shape, device="cuda", generator=g) * (0.02 if spec is wspec else 1.0)
        c = MOE_E if spec.per_channel else 1
        s = (x.abs().amax(dim=(1, 2)) if spec.per_channel else x.abs().amax().reshape(1)) / 100
        b = (torch.zeros(c, device="cuda") if spec is wspec
             else torch.full((1,), -0.4, device="cuda"))
        gr = torch.randn(shape, device="cuda", generator=g)
        for traced in (False, True):
            worst = max(worst, _check_fq(torch, x, s, b, gr, spec, rec["max_abs_err"],
                                         f"MoE {tuple(shape)}", traced))
    log(f"[check] act_quant_i8 and i8mm: {n_cases} cases bit-equal to their plain versions "
        f"and across two runs (static_int8_matmul over M {INT8_MS} x K {INT8_KS} x N "
        f"{INT8_NS}, signed / unsigned activations, per-channel / per-tensor / affine "
        f"weights; dynamic; NaN, +-inf, zeros; E={MOE_E} per-expert stacks; mobilenetv2's "
        f"stem, depthwise and 1x1 convs, symmetric and affine; {n_forms} of them the i8mm "
        f"forms: M at each row tile's and the fusion's threshold and either side, every "
        f"tile and cluster size, fused and unfused); fake-quant kernels at the "
        f"MoE shapes (per-expert weights on axis 0, expert activations): forward and dX "
        f"bit-exact, dS/dB worst {worst:.2e} of their term sums; {time.time() - t0:.1f} s")


def _check_i8mm_forms(torch, g):
    """i8mm's forms bit for bit against their plain versions, twice each:
    static and dynamic int8 matmuls at M on each side of every row tile's
    threshold (16, 32, 64, 128) and of the fusion's (FUSED_MAX_M), at three
    d1024 shapes and a ragged one; then, at ragged shapes, every tile and
    cluster size the plan can give (unfused; fused up to 64-row tiles,
    static and dynamic, +-inf and a NaN in x).  Returns the cases run."""
    import dataclasses

    from jaxlsq_torch.serve import matmul

    sx = torch.tensor([0.037], device="cuda")
    z = torch.tensor([131], dtype=torch.int32, device="cuda")
    cuts = sorted({c + d for c in (*matmul.I8MM_ROWS, matmul.FUSED_MAX_M) for d in (-1, 0, 1)
                   if c + d >= 1})
    n_cases = 0
    for k, n in ((1024, 1024), (4096, 1024), (1024, 3072), (1000, 1040)):
        p = _int8_pack(torch, (k, n), g, affine=True)
        for m in cuts:
            x = torch.randn(m, k, device="cuda", generator=g) * 2
            _equal_twice(torch, lambda: matmul.static_int8_matmul(x, p, sx, z, 0, 255),
                         lambda: matmul.static_int8_matmul_plain(x, p, sx, z, 0, 255),
                         f"i8mm forms: static M={m} K={k} N={n} "
                         f"{matmul.i8mm_plan(m, n, k, fused=True)}")
            _equal_twice(torch, lambda: matmul.dynamic_int8_matmul(x, p),
                         lambda: matmul.dynamic_int8_matmul_plain(x, p),
                         f"i8mm forms: dynamic M={m} K={k} N={n}")
            n_cases += 2
    for m, k, n in ((1, 1000, 1040), (37, 520, 200), (130, 1030, 136)):
        x = torch.randn(1, m, k, device="cuda", generator=g) * 2
        x.view(-1)[3], x.view(-1)[-2], x.view(-1)[m * k // 2] = (float("inf"), -float("inf"),
                                                                 float("nan"))
        b = torch.randint(-128, 128, (1, k, n), device="cuda", generator=g).to(torch.int8)
        sw = torch.rand(n, device="cuda", generator=g) * 0.01 + 1e-3
        zw = torch.randint(-7, 8, (n,), device="cuda", generator=g).to(torch.int32)
        q = (0, 1)
        xq, qx = matmul.act_quant_i8_plain(x, sx, z, 0, 255)
        want = matmul._i8mm(xq, b, qx, sw, zw, "static", q, plain=True)
        fused_want = {dyn: matmul._i8mm_fused(x, b, sw, zw, *((None, None, -128, 127) if dyn
                                                             else (sx, z, 0, 255)),
                                              dyn, q, plain=True)
                      for dyn in (False, True)}
        steps = -(-k // matmul.I8MM_BK)
        for bm in matmul.I8MM_ROWS:
            for bn in matmul.I8MM_COLS:
                if bn == 64 and bm > 64:
                    continue
                for cs in range(1, min(matmul.I8MM_MAX_CLUSTER, steps) + 1):
                    plan = matmul.i8mm_plan(m, n, k, bm=bm, bn=bn, cs=cs)
                    _equal_twice(torch, lambda: matmul._i8mm(xq, b, qx, sw, zw, "static", q,
                                                             plain=False, plan=plan),
                                 lambda: want, f"i8mm forms: {plan} M={m} K={k} N={n}")
                    n_cases += 1
                    if bm > 64 or bm * plan.kper > matmul._RESIDENT_MAX:
                        continue
                    fp = dataclasses.replace(plan, fused=True)
                    for dyn, w in fused_want.items():
                        args = (None, None, -128, 127) if dyn else (sx, z, 0, 255)
                        _equal_twice(torch, lambda: matmul._i8mm_fused(
                            x, b, sw, zw, *args, dyn, q, plain=False, plan=fp),
                            lambda: w, f"i8mm forms: {fp} dynamic={dyn} M={m} K={k} N={n}")
                        n_cases += 1
    return n_cases


class _Handover:
    """Deviation 14's hand-over for served models.  ``run(fn)`` runs the
    model with pre-hooks that keep the inputs of its quantized layers
    (``QuantConv``, ``QuantDense``, a ``QuantMoE``'s input at its
    ``experts_up`` qparams, each ``_ExpertDense``) in call order, and the
    gates of every routing call.  ``run(fn, take=True)`` on a hand-over
    given those records (``ref``, ``gates``): where an input element
    quantizes to another level than the reference's (one level at most, or
    it raises) the reference's value is handed over and counted; a token
    whose top-k experts differ from the reference's is handed the
    reference's gates if the reference's k-th and (k+1)-th gates lie within
    ROUTE_TIE (counted), and raises otherwise.  ``rows`` maps a call's rows
    to the reference's (a decode step's position), ``experts`` takes the
    expert layers too (same shapes: one full forward against another)."""

    def __init__(self, torch, model):
        from jaxlsq_torch.models import QuantConv, QuantDense, QuantMoE
        from jaxlsq_torch.models.moe import _ExpertDense

        self.torch, self.model = torch, model
        self.mods = [(n, m) for n, m in model.named_modules()
                     if isinstance(m, QuantMoE) or (isinstance(m, (QuantConv, QuantDense,
                                                                   _ExpertDense))
                                                    and m.aspec is not None)]
        self._lead = None
        self.ref, self.gates = {}, []
        self.moved = [0, 0]
        self.routes = [0, 0]

    @staticmethod
    def _levels(torch, mod, x):
        from jaxlsq_torch.serve.matmul import act_quant_i8_plain

        q = mod.experts_up if hasattr(mod, "experts_up") else mod
        return act_quant_i8_plain(x, q.act_scale, q.act_zp, q.aspec.quant_min,
                                  q.aspec.quant_max)[0].to(torch.int16)

    def run(self, fn, take=False, rows=None, experts=True):
        import jaxlsq_torch.models.moe as moe_mod

        torch = self.torch
        calls = {n: 0 for n, _ in self.mods}
        route_calls = [0]
        plain_route = moe_mod.route

        def pre(n, mod, args):
            x = args[0]
            if not take:
                self.ref.setdefault(n, []).append(x.detach().clone())
                return None
            i = calls[n]
            calls[n] += 1
            is_expert = type(mod).__name__ == "_ExpertDense"
            if is_expert and not experts:
                return None
            # one reference forward: a decode's every call maps to it
            ref = self.ref[n][i % len(self.ref[n])]
            if rows is not None and not is_expert:
                ref = rows(ref)
            if ref.shape != x.shape:
                raise AssertionError(f"[handover] {n}: shape {tuple(x.shape)} against the "
                                     f"reference's {tuple(ref.shape)}")
            d = self._levels(torch, mod, x) - self._levels(torch, mod, ref)
            if int(d.abs().max()) > 1:
                raise AssertionError(f"[handover] {n}: an input quantizes "
                                     f"{int(d.abs().max())} levels from the reference's")
            far = d != 0
            self.moved[0] += int(far.sum())
            self.moved[1] += x.numel()
            if bool(far.any()) and not hasattr(self, "first"):
                self.first = n
            return (torch.where(far, ref, x),) + tuple(args[1:])

        def route(gates, top_k, capacity, part=None):
            if not take:
                self.gates.append(gates.detach().clone())
                return plain_route(gates, top_k, capacity, part)
            ref = self.gates[route_calls[0] % len(self.gates)]
            route_calls[0] += 1
            if rows is not None:  # (B * T, E) -> the call's (b, t) rows
                ref = rows(ref.reshape(*self._lead, -1)).reshape(-1, ref.shape[-1])
            picks = torch.sort(gates, dim=-1, descending=True, stable=True)[1][:, :top_k]
            rvals, rpicks = torch.sort(ref, dim=-1, descending=True, stable=True)
            same = (picks.sort(-1)[0] == rpicks[:, :top_k].sort(-1)[0]).all(-1)
            self.routes[1] += gates.shape[0]
            if not bool(same.all()):
                tie = (rvals[:, top_k - 1] - rvals[:, top_k]).abs() <= ROUTE_TIE
                if bool((~same & ~tie).any()):
                    raise AssertionError("[handover] a routing pick differs from the "
                                         "reference's away from a near-tie")
                self.routes[0] += int((~same).sum())
                gates = torch.where(same[:, None], gates, ref)
            return plain_route(gates, top_k, capacity, part)

        hooks = [m.register_forward_pre_hook(lambda mod, a, n=n: pre(n, mod, a))
                 for n, m in self.mods]
        moe_mod.route = route
        try:
            with torch.no_grad():
                return fn()
        finally:
            moe_mod.route = plain_route
            for h in hooks:
                h.remove()


def _handed_over(torch, ref_model, model, x):
    """``model(x)`` handed over (``_Handover``) against ``ref_model(x)``:
    the two outputs and the hand-over."""
    ref = _Handover(torch, ref_model)
    want = ref.run(lambda: ref_model(x))
    hand = _Handover(torch, model)
    hand.ref, hand.gates = ref.ref, ref.gates
    return hand.run(lambda: model(x), take=True), want, hand


def _decode_handover(torch, model, seq, t0):
    """The served ``model``'s prefill of ``seq[:, :t0]`` and decode steps over
    the rest, handed over (``_Handover``) against its own full forward of
    ``seq``: the decode logits of positions t0 - 1 .. len - 2, the full
    forward's, and the hand-over."""
    from jaxlsq_torch.serve import prefill

    hand = _Handover(torch, model)
    full = hand.run(lambda: model(seq))
    b, length = seq.shape
    hand._lead = (b, length)
    cur = [0, t0]

    def rows(ref):  # (B, T, ...) -> the call's positions
        return ref[:, cur[0]:cur[1]]

    def decode():
        last, cache, idx = prefill(model, seq[:, :t0])
        out = [last]
        for t in range(t0, length - 1):
            cur[:] = [t, t + 1]
            logits, cache = model(seq[:, t:t + 1], cache=cache, cache_index=t)
            out.append(logits[:, 0])
        return torch.stack(out, 1)

    dec = hand.run(decode, take=True, rows=rows, experts=False)
    return dec, full[:, t0 - 1:length - 1], hand


def _int8_served_lms(torch, modes=("none", "static", "static_int8", "dynamic")):
    """The d1024 x 4 LM at w8: QAT variables drawn from a seed, calibrated on 4
    seeded token batches, converted and served in each of ``modes``; and
    the generator that drew the batches, to draw prompts next."""
    from jaxlsq_torch import interop
    from jaxlsq_torch.models import QuantTransformerLM, calibrate, default_qconfig

    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=1)
    qat = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, qc, max_len=240, device="cuda", seed=17)
    g = torch.Generator(device="cuda").manual_seed(171)
    calibrate(qat, [torch.randint(0, VOCAB, (4, 64), device="cuda", generator=g)
                    for _ in range(4)])
    tree = interop.qat_variables(qat)
    del qat
    served = {}
    for mode in modes:
        served[mode] = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, qc.for_serving(mode),
                                          max_len=240, device="cuda")
        interop.load_variables(served[mode], tree)
    return served, g


def _int8_dense_lm(torch, card):
    """The d1024 x 4 LM at w8 (``_int8_served_lms``) served 'none',
    'static', 'static_int8' and 'dynamic'."""
    from jaxlsq_torch.models import QuantDense
    from jaxlsq_torch.serve.matmul import wo_matmul_plain

    out = {}
    served, g = _int8_served_lms(torch)
    prompt = torch.randint(0, VOCAB, (2, 96), device="cuda", generator=g)
    # 'static_int8' against 'static': the prefill logits, handed over
    got, want, hand = _handed_over(torch, served["static"], served["static_int8"], prompt)
    err = float((got - want).abs().max())
    tol = 1e-4 * float(want.abs().max())
    out["static_int8_vs_static"] = {"max_abs_err": err, "tol": tol, "moved": hand.moved,
                                    "first_moved": getattr(hand, "first", None)}
    log(f"[int8] d1024x4 LM, w8, calibrated: 'static_int8' prefill logits (B=2, t=96) vs "
        f"'static' max_abs_err {err:.3e} (tol {tol:.3e}); {hand.moved[0]} of {hand.moved[1]} "
        f"dense-layer input elements quantized one level over and handed over (first: "
        f"{getattr(hand, 'first', None)})")
    if not err <= tol or hand.moved[0] > MAX_DECODE_MOVED * hand.moved[1]:
        raise AssertionError(f"[int8] static_int8 vs static: {err} > {tol} or "
                             f"{hand.moved} moved")
    # 'dynamic': every dynamic_int8_matmul of one decode step within 2e-2 of
    # x @ dequant(W) (the JAX package's bound); the logits against 'none'
    from jaxlsq_torch.serve import make_generate, prefill

    worst = [0.0, 0]

    def check(mod, inp, y):
        ref = wo_matmul_plain(inp[0], mod.kernel.packed())
        if mod.bias is not None:
            ref = ref + mod.bias
        worst[0] = max(worst[0], float((y - ref).abs().max() / ref.abs().max()))
        worst[1] += 1

    dyn = served["dynamic"]
    for b in (1, 8):
        toks = make_generate(dyn, 32, 16, cache_dtype=torch.bfloat16)(prompt[:1].repeat(b, 1)[:, :32])
        if toks.shape != (b, 16):
            raise AssertionError(f"[int8] dynamic generate gave {tuple(toks.shape)}")
    hooks = [m.register_forward_hook(check) for m in dyn.modules() if isinstance(m, QuantDense)]
    try:
        with torch.no_grad():
            last, cache, idx = prefill(dyn, prompt[:, :32])
            worst[:] = [0.0, 0]
            dyn(prompt[:, 32:33], cache=cache, cache_index=32)
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        ld, ln = served["dynamic"](prompt), served["none"](prompt)
    rel = float((ld - ln).abs().max() / ln.abs().max())
    out["dynamic"] = {"decode_step_worst_rel": worst[0], "calls": worst[1],
                      "logits_rel_vs_none": rel}
    log(f"[int8] 'dynamic': generate at B=1 and 8; the {worst[1]} dynamic_int8_matmul calls "
        f"of one decode step within {worst[0]:.3e} of x @ dequant(W) relative (bound 2e-2); "
        f"prefill logits relative error vs 'none' {rel:.3e}")
    if not worst[0] <= 2e-2 or worst[1] != 4 * DEPTH + 1:
        raise AssertionError(f"[int8] dynamic matmuls off: {worst}")
    tps = {}
    for mode in ("none", "static_int8", "dynamic"):
        tps[mode], _, _ = _slope_tps(torch, served[mode], 1, prompt[:1, :T0], torch.bfloat16,
                                     n1=INT8_N1, n2=INT8_N2, rounds=1)
    out["kernels_a_token"] = _kernels_per_step(
        torch, lambda n: make_generate(served["static_int8"], T0, n,
                                       cache_dtype=torch.bfloat16)(prompt[:1, :T0]),
        INT8_N1 // 4, INT8_N1)
    out["tokens_per_s_b1"] = tps
    # where a B = 1 token's time goes in each mode: one profiled generate
    prof = out["profile_b1"] = {}
    for mode in ("none", "static_int8", "dynamic"):
        p = _profile_generate(torch, served[mode], prompt[:1, :T0], INT8_N2)
        prof[mode] = {k: p[k] for k in ("wall_ms", "device_ms", "busy_share",
                                        "kernels_per_token")}
        prof[mode]["top"] = p["top"][:6]
    log(f"[int8] decode tokens/s at B=1 (slope {INT8_N1} -> {INT8_N2}, bf16 cache): "
        + ", ".join(f"{k} {v:.1f}" for k, v in tps.items())
        + f"; 'static_int8' {out['kernels_a_token']:.1f} kernels a token; profiled "
        f"{INT8_N2}-token generates: " + "; ".join(
            f"{k} {v['kernels_per_token']:.1f} kernels a token, busy "
            f"{100 * v['busy_share']:.1f}% ({v['device_ms']:.1f} of {v['wall_ms']:.1f} ms)"
            for k, v in prof.items()) + f" ({card})")
    return out


def _int8_mnv2(torch, mm, card):
    """mobilenetv2_cifar at w8a8, calibrated on 4 grating batches, served
    'static' and 'static_int8' at B = 128; ServingEngine over the int8 net."""
    import numpy as np

    from jaxlsq_torch import interop
    from jaxlsq_torch.lab.accuracy_parity import make_batch
    from jaxlsq_torch.models import QuantConv, QuantDense, calibrate, mobilenetv2_cifar
    from jaxlsq_torch.serve import ServingEngine
    from jaxlsq_torch.serve.matmul import (FUSED_MAX_M, static_int8_conv_plain,
                                           static_int8_matmul_plain)

    out = {}
    model = _mnv2(torch, "cuda", 8)
    g = torch.Generator(device="cuda").manual_seed(172)
    calibrate(model, [make_batch(MNV2_B, g, "cuda")[0] for _ in range(4)])
    tree, qc = interop.qat_variables(model), model.qconfig
    del model
    nets = {}
    for mode in ("static", "static_int8"):
        nets[mode] = mobilenetv2_cifar(MNV2_CLASSES, qc.for_serving(mode), device="cuda")
        interop.load_variables(nets[mode], tree)
        nets[mode].eval()
    net = nets["static_int8"]
    images = make_batch(MNV2_B, g, "cuda")[0]
    n_conv = sum(isinstance(m, QuantConv) for m in net.modules())
    # every layer's kernels against their plain versions at B = 128
    bad = []

    def check(mod, inp, y):
        x = inp[0]
        a = (mod.act_scale, mod.act_zp, mod.aspec.quant_min, mod.aspec.quant_max)
        if isinstance(mod, QuantConv):
            ref = static_int8_conv_plain(x, mod.kernel.packed(), *a, strides=mod.strides,
                                         padding=mod.padding, feature_group_count=mod.groups)
            ref = ref + mod.bias[:, None, None] if mod.bias is not None else ref
        else:
            ref = static_int8_matmul_plain(x, mod.kernel.packed(), *a)
            ref = ref + mod.bias if mod.bias is not None else ref
        if not torch.equal(y, ref):
            bad.append(type(mod).__name__)

    hooks = [m.register_forward_hook(check) for m in net.modules()
             if isinstance(m, (QuantConv, QuantDense))]
    try:
        with torch.no_grad():
            net(images)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"[int8] mobilenetv2 layers differ from their plain versions: {bad}")
    before = dict(mm)
    with torch.no_grad():
        logits = net(images)
    torch.cuda.synchronize()
    launches = {k: mm[k] - before[k] for k in mm}
    out["launches_a_forward"] = launches
    # the convs quantize by act_quant_i8 (im2col gathers int8 windows); the
    # classifier's B rows in i8mm itself up to FUSED_MAX_M
    head_fused = int(MNV2_B <= FUSED_MAX_M)
    if not (launches["i8mm"] == n_conv + 1 and launches["i8mm_fused"] == head_fused
            and launches["act_quant_i8"] == n_conv + 1 - head_fused
            and launches["wo8"] == 0 and torch.isfinite(logits).all()):
        raise AssertionError(f"[int8] mobilenetv2 static_int8 forward launched {launches} "
                             f"({n_conv} convs and the classifier)")
    # the int8 forward's device time at B = MNV2_B (three image batches in turn)
    with torch.no_grad():
        ims = [images] + [images.clone() for _ in range(2)]
        out["forward_ms"] = min(measure(net, [(x,) for x in ims], 10)[0] for _ in range(2))
    got, want, hand = _handed_over(torch, nets["static"], net, images)
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= 5e-3 + 5e-3 * want.abs()).all())
    out["static_int8_vs_static"] = {"max_abs_err": err, "moved": hand.moved,
                                    "first_moved": getattr(hand, "first", None)}
    log(f"[int8] mobilenetv2_cifar w8a8 at B={MNV2_B}: every conv and the classifier "
        f"bit-equal to their plain versions; a forward launches {launches['i8mm']} i8mm and "
        f"{launches['act_quant_i8']} act_quant_i8 ({n_conv} convs + classifier), no wo8; "
        f"'static_int8' vs 'static' logits max_abs_err {err:.3e} (tol 5e-3 + 5e-3 |ref|), "
        f"{hand.moved[0]} of {hand.moved[1]} layer-input elements a level over, handed over; "
        f"the forward {out['forward_ms']:.3f} ms on the device "
        f"({1e3 * MNV2_B / out['forward_ms']:.0f} images/s; {card})")
    if not ok:
        raise AssertionError(f"[int8] mobilenetv2 static_int8 vs static: {err}")
    # ServingEngine captures the int8 path, a graph a bucket
    reqs = make_batch(48, g, "cuda")[0].cpu().numpy()
    r = np.random.RandomState(173)
    with ServingEngine(net, reqs.shape[1:], max_batch=16) as eng:
        futs, i = [], 0
        while i < len(reqs):
            k = int(r.randint(1, 17))
            futs += eng.submit_many(list(reqs[i:i + k]))
            i += k
            time.sleep(0.002)
        res = [f.result(timeout=300) for f in futs]
        sizes = list(eng.stats["batch_sizes"])
        caps = dict(eng.captures)
    j = 0
    for k in sizes:
        b = eng._bucket_for(k)
        x = np.zeros((b,) + reqs.shape[1:], np.float32)
        x[:k] = reqs[j:j + k]
        with torch.no_grad():
            w = net(torch.as_tensor(x, device="cuda")).cpu().numpy()
        if not np.array_equal(np.stack(res[j:j + k]), w[:k]):
            raise AssertionError(f"[int8] ServingEngine bucket {b}: replay != eager")
        j += k
    used = {eng._bucket_for(k) for k in sizes}
    if any(caps[b] != (1 if b in used else 0) for b in caps):
        raise AssertionError(f"[int8] ServingEngine captures {caps} (used {sorted(used)})")
    out["engine"] = {"batches": sizes, "captures": caps}
    log(f"[int8] ServingEngine over the static_int8 net: {len(reqs)} requests in "
        f"{len(sizes)} batches, buckets {sorted(used)} captured once each, every result the "
        f"eager forward of its padded batch bit for bit ({card})")
    return out


def _moe_model(torch, qc, device, cf):
    """The d1024 x 4 MoE LM at capacity ``cf`` (QAT mode: drawn from seed 19)."""
    from jaxlsq_torch.models import QuantTransformerLM

    return QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, qc, max_len=MOE_T, device=device,
                              moe_experts=MOE_E, moe_top_k=MOE_TOP_K, moe_capacity_factor=cf,
                              seed=19)


def _moe_probe(torch, model, batch):
    """A frozen no-grad forward of the QAT MoE LM on ``batch``: the aux terms
    it records and the routing picks dropped at its capacity."""
    import jaxlsq_torch.models.moe as moe_mod
    from jaxlsq_torch.models.layers import FakeQuantize, collect_losses, quant_state_frozen

    plain = moe_mod.route
    drops = [0, 0]

    def route(gates, k, c, part=None):
        d, cmb = plain(gates, k, c, part)
        drops[0] += gates.shape[0] * k - int(d.sum())
        drops[1] += gates.shape[0] * k
        return d, cmb

    moe_mod.route = route
    try:
        with quant_state_frozen([m for m in model.modules() if isinstance(m, FakeQuantize)]):
            with collect_losses() as terms, torch.no_grad():
                model(batch["input"])
    finally:
        moe_mod.route = plain
    return [float(t) for t in terms], drops


def _moe_lm(torch, card):
    """The d1024 x 4 MoE LM (8 experts, top-2): 6 steps from one state, eager
    and captured, equal leaf by leaf; converted at w8 and w4 stacks and
    served at capacity E / top_k."""
    import copy

    import numpy as np

    from jaxlsq_torch import interop
    from jaxlsq_torch.models import default_qconfig
    from jaxlsq_torch.parallel import make_train_step

    out = {}
    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=2)
    models = [_moe_model(torch, qc, "cuda", MOE_CF) for _ in range(2)]
    opts = [_sgd(torch, m) for m in models]
    steps = [make_train_step(m, o, jit=j) for m, o, j in zip(models, opts, (False, True))]
    g = torch.Generator(device="cuda").manual_seed(174)
    batches = []
    for _ in range(MOE_STEPS):
        x = torch.randint(0, VOCAB, (MOE_B, MOE_T + 1), device="cuda", generator=g)
        batches.append({"input": x[:, :-1].contiguous(), "label": x[:, 1:].contiguous()})
    losses, unequal, probes = [], [], []
    t_train = time.time()
    for i, batch in enumerate(batches):
        aux, drops = _moe_probe(torch, models[0], batch)
        if not (len(aux) == DEPTH and all(math.isfinite(a) and a > 0 for a in aux)):
            raise AssertionError(f"[moe] aux loss terms {aux}")
        probes.append({"aux": aux, "dropped_picks": drops})
        pair = [s(batch)["loss"] for s in steps]
        losses.append([float(v) for v in pair])
        states = [{"loss": v, **_train_state(m, o)} for v, m, o in zip(pair, models, opts)]
        for name, a in states[0].items():
            if not torch.equal(a, states[1][name]):
                unequal.append({"step": i + 1, "leaf": name})
    torch.cuda.synchronize()
    train_s = time.time() - t_train
    _graph_of(steps[1])
    for _ in range(2):  # the captured step's time (replays)
        steps[1](batches[0])
    torch.cuda.synchronize()
    s = time.perf_counter()
    for b in batches[:3]:
        steps[1](b)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - s) / 3
    out["train"] = {"losses": losses, "unequal": unequal, "probes": probes,
                    "step_ms_captured": step_ms, "wall_s": train_s}
    log(f"[moe] d1024x4 LM, {MOE_E} experts top-{MOE_TOP_K}, capacity {MOE_CF}, B={MOE_B}, "
        f"t={MOE_T}: {MOE_STEPS} steps eager and captured from one state, losses {losses}; "
        f"{len(unequal)} leaves not bit-equal; aux terms "
        f"{[round(sum(p['aux']), 5) for p in probes]}; picks dropped a step "
        f"{[p['dropped_picks'][0] for p in probes]} of {probes[0]['dropped_picks'][1]}; a "
        f"captured step {step_ms:.1f} ms ({card})")
    if unequal:
        raise AssertionError(f"[moe] eager and captured steps differ: {unequal[:5]}")
    tree = interop.qat_variables(models[0])
    del models, opts, steps
    torch.cuda.empty_cache()
    # w4 stacks: the experts re-quantized at 4 bits (per-expert |w|max / 7)
    qc4 = default_qconfig(4, 8, per_channel_weights=True, init_batches=2)
    tree4 = dict(tree, qparams=copy.deepcopy(tree["qparams"]))
    for i in range(DEPTH):
        for sub in ("experts_up", "experts_down"):
            w = tree["params"][f"block{i}"]["moe"][sub]["kernel"]
            qp = tree4["qparams"][f"block{i}"]["moe"][sub]["weight_fq"]["qp"]
            qp["scale"] = (np.abs(w).max(axis=(1, 2)) / 7).astype(np.float32)
    legs = {}
    for wbits, qcw, t in ((8, qc, tree), (4, qc.with_overrides({"moe": qc4}), tree4)):
        legs[f"w{wbits}"] = _moe_serve(torch, qcw, t, wbits, card)
    out["serve"] = legs
    return out


def _moe_serve(torch, qc, tree, wbits, card):
    """The MoE LM served at capacity E / top_k: make_generate greedy at B = 1
    and 8, its decode logits within 1e-4 of the full forward (handed over);
    DecodeEngine over 8 staggered requests equal to their B = 1 decodes;
    'static_int8' within 1e-4 of 'static' (handed over); tokens/s."""
    import numpy as np

    from jaxlsq_torch import interop
    from jaxlsq_torch.serve import DecodeEngine, make_generate
    from jaxlsq_torch.serve.matmul import LAUNCHES as MM

    out = {}
    served = {}
    for mode in ("static", "static_int8"):
        served[mode] = _moe_model(torch, qc.for_serving(mode), "cuda", MOE_SERVE_CF)
        interop.load_variables(served[mode], tree)
    sm = served["static"]
    packs = sm.block0.moe.experts_up.kernel
    if packs.bits != wbits:
        raise AssertionError(f"[moe] w{wbits}: the expert stack packed at {packs.bits} bits")
    g = torch.Generator(device="cuda").manual_seed(175 + wbits)
    prompt = torch.randint(0, VOCAB, (8, 32), device="cuda", generator=g)
    handed = [0, 0, 0, 0]
    worst = 0.0
    for b in (1, 8):
        before = dict(MM)
        toks = make_generate(sm, 32, 16, cache_dtype=torch.float32)(prompt[:b])
        key = "wo8" if wbits == 8 else "wo4"
        if MM[key] - before[key] <= 0:
            raise AssertionError(f"[moe] w{wbits}: generate launched no {key}")
        seq = torch.cat([prompt[:b], toks.to(prompt.dtype)], 1)
        dec, full, hand = _decode_handover(torch, sm, seq, 32)
        err = float((dec - full).abs().max())
        tol = 1e-4 * float(full.abs().max())
        worst = max(worst, err / tol)
        handed = [handed[0] + hand.moved[0], handed[1] + hand.moved[1],
                  handed[2] + hand.routes[0], handed[3] + hand.routes[1]]
        if not err <= tol:
            raise AssertionError(f"[moe] w{wbits} B={b}: decode logits vs the full forward "
                                 f"{err} > {tol}")
    # DecodeEngine: 8 staggered requests, each equal to its own B = 1 decode
    r = np.random.RandomState(176)
    reqs = [(prompt[i, :int(r.randint(4, 33))].cpu().numpy(), int(r.randint(4, 17)))
            for i in range(8)]
    with DecodeEngine(sm, max_batch=8, prompt_buckets=(32,)) as eng:
        futs = []
        for p, n in reqs:
            futs.append(eng.submit(p, n))
            time.sleep(0.003)
        got = [f.result(timeout=300) for f in futs]
    for (p, n), toks in zip(reqs, got):
        want = make_generate(sm, len(p), n)(torch.as_tensor(p[None], device="cuda"))
        if not np.array_equal(np.asarray(toks), want[0].cpu().numpy()):
            raise AssertionError(f"[moe] w{wbits}: an engine request differs from its "
                                 "B=1 decode")
    # 'static_int8' against 'static' (the int8 experts unpack an int4 stack)
    before = dict(MM)
    got, want, hand = _handed_over(torch, sm, served["static_int8"], prompt[:2])
    i8 = MM["i8mm"] - before["i8mm"]
    err = float((got - want).abs().max())
    tol = 1e-4 * float(want.abs().max())
    handed = [handed[0] + hand.moved[0], handed[1] + hand.moved[1],
              handed[2] + hand.routes[0], handed[3] + hand.routes[1]]
    tps = None
    if wbits == 8:  # the w4 stacks decode the same way
        tps, _, _ = _slope_tps(torch, sm, 1, prompt[:1], torch.float32, n1=INT8_N1,
                               n2=INT8_N2, rounds=1)
    out = {"decode_vs_full_worst_of_tol": worst, "engine_requests": len(reqs),
           "int8_vs_static_err": err, "int8_vs_static_tol": tol, "i8mm_a_forward": i8,
           "moved": handed[:2], "routes_handed": handed[2:], "tokens_per_s_b1": tps}
    log(f"[moe] w{wbits} stacks, capacity {MOE_SERVE_CF}: generate at B=1 and 8, decode "
        f"logits within {worst:.2f} of the 1e-4 tolerance of the full forward; DecodeEngine "
        f"over 8 staggered requests = their B=1 decodes; 'static_int8' vs 'static' "
        f"{err:.3e} (tol {tol:.3e}, {i8} i8mm a forward); {handed[0]} of {handed[1]} "
        f"activation elements and {handed[2]} of {handed[3]} routed tokens handed over; "
        + (f"decode {tps:.1f} tokens/s at B=1 " if tps else "") + f"({card})")
    if not err <= tol or i8 != 4 * DEPTH + 1:
        raise AssertionError(f"[moe] w{wbits} static_int8 vs static {err} > {tol} or "
                             f"{i8} i8mm launches")
    if handed[0] > MAX_DECODE_MOVED * handed[1] or handed[2] > MAX_ROUTE_HANDED * handed[3]:
        raise AssertionError(f"[moe] w{wbits}: too many handed over: {handed}")
    return out


def _time_int8(torch, card):
    """act_quant_i8 (I1) and i8mm (I2, static epilogue) at the d1024 LM's five
    layer shapes, M = 1, 8, 256: device µs of I1, of I2 alone (its plan for
    int8 rows), of the fused path (one launch quantizing its rows; at M =
    256 a forced 64-row fused plan where one fits) and of the static layer
    as served (the fused launch up to FUSED_MAX_M rows, else I1 then I2),
    beside wo8 on the same weight, torch._int_mm (where it takes the shape:
    M > 16), torch.quantize_per_tensor (I1's yardstick: an affine
    quantization to a quint8 tensor), the plain versions and the bounds
    (bytes at 3.35 TB/s; int8 operations at 1,979 TOPS).  Then the fused
    path against I1 + I2 at M = 32, 64 and 128 (the crossover)."""
    import dataclasses as dc

    from jaxlsq_torch.serve.matmul import (_RESIDENT_MAX, FUSED_MAX_M, I8MM_BK,
                                           I8MM_MAX_CLUSTER, _i8mm, _i8mm_fused, act_quant_i8,
                                           act_quant_i8_plain, i8mm_plan, static_int8_matmul,
                                           wo_matmul)

    g = torch.Generator(device="cuda").manual_seed(177)
    rows, cross = [], []
    sx = torch.tensor([0.03], device="cuda")
    z = torch.tensor([128], dtype=torch.int32, device="cuda")

    def fused_plan(m, k, n):
        """The served fused plan, or above FUSED_MAX_M one forced on 64-row
        tiles with the cluster that keeps a rank's rows resident (32 KB)."""
        plan = i8mm_plan(m, n, k, fused=True)
        if plan.fused:
            return plan
        base = i8mm_plan(m, n, k, bm=min(64, plan.bm))
        per = _RESIDENT_MAX // base.bm // I8MM_BK
        cs = min(I8MM_MAX_CLUSTER, max(base.cs, -(-(-(-k // I8MM_BK)) // per)))
        plan = i8mm_plan(m, n, k, bm=base.bm, bn=base.bn, cs=cs)
        return dc.replace(plan, fused=True) if plan.bm * plan.kper <= _RESIDENT_MAX else None

    for layer, (k, n) in WO_SHAPES.items():
        p = _int8_pack(torch, (k, n), g)
        wbytes = k * n + 8 * n
        packs = [p] + [dc.replace(p, data=p.data.clone(), scale=p.scale.clone(),
                                  zero_point=p.zero_point.clone())
                       for _ in range(copies_for(wbytes) - 1)]
        for m in INT8_TIMED_MS + (32, 64, 128):
            x = torch.randn(m, k, device="cuda", generator=g)
            xq, qx = act_quant_i8(x, sx, z, 0, 255)
            fp = fused_plan(m, k, n)
            xs = [x] + [x.clone() for _ in range(copies_for(4 * m * k) - 1)]

            def i2(q, xq=xq, qx=qx):
                return _i8mm(xq[None], q.data[None], qx, q.scale, q.zero_point, "static",
                             (0, 1), plain=False)

            def fused(q, a, fp=fp):
                return _i8mm_fused(a[None], q.data[None], q.scale, q.zero_point, sx, z, 0,
                                   255, False, (0, 1), plain=False, plan=fp)

            args = [(packs[i % len(packs)], xs[i % len(xs)])
                    for i in range(max(len(packs), len(xs)))]
            i1_ms, _ = measure(lambda a: act_quant_i8(a, sx, z, 0, 255), [(a,) for a in xs])
            i2_ms, _ = measure(i2, [(q,) for q in packs])
            f_ms = measure(fused, args)[0] if fp is not None else None
            if m not in INT8_TIMED_MS:
                cross.append({"layer": layer, "M": m, "K": k, "N": n, "i1_ms": i1_ms,
                              "i2_ms": i2_ms, "fused_ms": f_ms, "plan": dc.astuple(fp)
                              if fp else None})
                continue
            lay_ms, _ = measure(lambda q, a: static_int8_matmul(a, q, sx, z, 0, 255), args)
            i1_plain, _ = measure(lambda a: act_quant_i8_plain(a, sx, z, 0, 255),
                                  [(a,) for a in xs], reps=10)
            i1_lib, _ = measure(lambda a: torch.quantize_per_tensor(a, 0.03, 128, torch.quint8),
                                [(a,) for a in xs])

            def i2_plain(q, xq=xq, qx=qx):
                return _i8mm(xq[None], q.data[None], qx, q.scale, q.zero_point, "static",
                             (0, 1), plain=True)

            i2p_ms, _ = measure(i2_plain, [(q,) for q in packs], reps=5)
            wo_ms, _ = measure(wo_matmul, [(x, q) for q in packs])
            lib = None
            if m > 16:  # the yardstick only: a refusal is logged, not fatal
                try:
                    lib, _ = measure(torch._int_mm, [(xq, q.data) for q in packs])
                except RuntimeError as e:
                    log(f"[time] torch._int_mm refused M={m} K={k} N={n}: {e}")
            i1_b = bound(5 * m * k, 0)  # 4 bytes read, 1 written an element
            nbytes = m * k + wbytes + 4 * m * n + 8
            tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, 2 * m * k * n / 1979e12 * 1e3
            fb = (4 * m * k + wbytes + 4 * m * n + 8) / HBM_BYTES_PER_S * 1e3  # x read as f32
            rows.append({"layer": layer, "M": m, "K": k, "N": n, "i1_ms": i1_ms,
                         "i1_plain_ms": i1_plain, "i1_library_ms": i1_lib,
                         "i1_bound_ms": i1_b[0], "i2_ms": i2_ms, "i2_plain_ms": i2p_ms,
                         "i2_bound_ms": max(tb, tf),
                         "i2_bound_by": "bytes" if tb >= tf else "operations",
                         "fused_ms": f_ms, "fused_bound_ms": max(fb, tf),
                         "layer_ms": lay_ms, "layer_fused": m <= FUSED_MAX_M,
                         "plan": dc.astuple(i8mm_plan(m, n, k)),
                         "fused_plan": dc.astuple(fp) if fp else None,
                         "wo8_ms": wo_ms, "int_mm_ms": lib, "bytes": nbytes})
    by_m = {}
    keys = ("i1_ms", "i2_ms", "wo8_ms", "i1_bound_ms", "i2_bound_ms", "i1_plain_ms",
            "i2_plain_ms", "i1_library_ms", "layer_ms", "fused_bound_ms")
    for m in INT8_TIMED_MS:
        rs = [r for r in rows if r["M"] == m]
        by_m[m] = {k: sum(r[k] for r in rs) for k in keys}
        for key in ("int_mm_ms", "fused_ms"):
            vals = [r[key] for r in rs]
            by_m[m][key] = sum(vals) if all(v is not None for v in vals) else None
        log(f"[time] d1024 layers summed at M={m}: act_quant_i8 {by_m[m]['i1_ms'] * 1e3:.2f} us "
            f"(bound {by_m[m]['i1_bound_ms'] * 1e3:.2f}, torch.quantize_per_tensor "
            f"{by_m[m]['i1_library_ms'] * 1e3:.2f}), i8mm {by_m[m]['i2_ms'] * 1e3:.2f} us "
            f"(bound {by_m[m]['i2_bound_ms'] * 1e3:.2f}), fused "
            + (f"{by_m[m]['fused_ms'] * 1e3:.2f} us" if by_m[m]["fused_ms"] else "n/a")
            + f", the static layer {by_m[m]['layer_ms'] * 1e3:.2f} us, wo8 "
            f"{by_m[m]['wo8_ms'] * 1e3:.2f} us, torch._int_mm "
            + (f"{by_m[m]['int_mm_ms'] * 1e3:.2f} us" if by_m[m]["int_mm_ms"] else "refused")
            + f"; plain {by_m[m]['i1_plain_ms'] * 1e3:.1f} / {by_m[m]['i2_plain_ms'] * 1e3:.1f} us"
            f" ({card})")
    by_cross = {}
    for m in sorted({r["M"] for r in cross}):
        rs = [r for r in cross if r["M"] == m]
        fs = [r["fused_ms"] for r in rs]
        by_cross[m] = {"fused_ms": sum(fs) if all(v is not None for v in fs) else None,
                       "i1_i2_ms": sum(r["i1_ms"] + r["i2_ms"] for r in rs)}
    log("[time] fused vs act_quant_i8 + i8mm, the five shapes summed: " + "; ".join(
        f"M={m} " + (f"{v['fused_ms'] * 1e3:.2f}" if v["fused_ms"] else "n/a")
        + f" / {v['i1_i2_ms'] * 1e3:.2f} us" for m, v in by_cross.items()) + f" ({card})")
    return {"rows": rows, "by_m": by_m, "crossover": cross, "by_crossover": by_cross}


def phase_int8_moe(torch, rec):
    """Phase 17: the kernels' checks, then with every count at 0 the dense
    LM's int8 modes, mobilenetv2's int8 serving and the MoE LM; then the
    kernels' times."""
    out = rec["int8_moe"] = {}
    t_start = time.time()
    _check_int8_kernels(torch, rec)
    legs = out["leg_s"] = {"checks": time.time() - t_start}
    mm, attn, fq = reset_counts()
    s = time.time()
    out["dense_lm"] = _int8_dense_lm(torch, rec["card"])
    legs["dense_lm"], s = time.time() - s, time.time()
    out["mnv2"] = _int8_mnv2(torch, mm, rec["card"])
    legs["mnv2"], s = time.time() - s, time.time()
    out["moe"] = _moe_lm(torch, rec["card"])
    torch.cuda.synchronize()
    legs["moe"], s = time.time() - s, time.time()
    out["launches"] = {**fq, **mm, **attn}
    for k in INT8_KERNELS + ("i8mm_fused", "wo8", "wo4", "fq_fwd_pt", "fq_fwd_pc", "fq_bwd_pt",
                             "fq_bwd_pc",
                             "fq_fwd_pt_traced", "fq_fwd_pc_traced", "decode_attention"):
        if out["launches"][k] <= 0:
            raise AssertionError(f"kernel {k} was never launched on the int8 / MoE path")
    out["times"] = _time_int8(torch, rec["card"])
    legs["times"] = time.time() - s
    out["wall_s"] = time.time() - t_start
    log(f"[int8] kernel launches on the int8 / MoE path: {out['launches']}; phase 17 took "
        f"{out['wall_s']:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in legs.items()) + ")")


def _tool_mnv2(torch, qc, seed):
    """mobilenetv2_cifar under ``qc``: calibrated on TOOL_CALIB grating
    batches, handed to LSQ learning (observers off), then TOOL_STEPS captured
    steps at B = MNV2_B under the protocol's optimizer; returns the model, an
    eval batch and StepTimer's steps/s."""
    from jaxlsq_torch.models import calibrate, enable_param_learning_all, mobilenetv2_cifar
    from jaxlsq_torch.parallel import make_train_step
    from jaxlsq_torch.utils import StepTimer

    model = mobilenetv2_cifar(MNV2_CLASSES, qc, device="cuda", seed=0)
    batches = _grating_batches(torch, TOOL_CALIB + TOOL_STEPS + 1, MNV2_B, seed=seed)
    calibrate(model, [b["image"] for b in batches[:TOOL_CALIB]])
    enable_param_learning_all(model)
    step = make_train_step(model, _adamw(torch, model), jit=True)
    timer, rate, losses = StepTimer(warmup=2), None, []
    for b in batches[TOOL_CALIB:-1]:
        losses.append(step(b)["loss"])
        rate = timer.tick(losses[-1]) or rate
    if not all(math.isfinite(float(v)) for v in losses) or not (rate or 0) > 0:
        raise AssertionError(f"[tooling] losses {losses}, StepTimer {rate}")
    return model, batches[-1], rate


def _unchanged(torch, model, before, what):
    after = _quantizer_state(model)
    bad = [k for k, v in before.items() if not torch.equal(v, after[k])]
    if bad or model.training:
        raise AssertionError(f"[tooling] {what} left {bad[:4]} changed "
                             f"(training={model.training})")


def _losses(sens, plan):
    """Every loss a sensitivity report and a plan evaluated, by name."""
    out = {"sens/float": sens["baseline_float"], "sens/quant": sens["baseline_quant"],
           "plan/float": plan["baseline_float"],
           "plan/planned": plan["planned_quant_loss"]}
    for r in sens["rows"]:
        out[f"sens/{r['scope']}/only"] = r["quant_only"]
        out[f"sens/{r['scope']}/loo"] = r["leave_one_out"]
    for b, v in plan["uniform"].items():
        out[f"plan/uniform{b}"] = v
    for r in plan["rows"]:
        for b in (4, 8):
            out[f"plan/{r['scope']}/{b}"] = r[f"damage_{b}b"] + plan["baseline_float"]
    return out


def _near_ties(ref, got, rel):
    """The scopes whose bits differ between two plans, each paired with a
    scope of the other width in ``ref`` whose damage-per-byte gain lies within
    what a relative error ``rel`` of the losses can move (else raises)."""
    rows = {r["scope"]: r for r in ref["rows"]}
    eps = 2 * rel * max(abs(v) for v in [ref["baseline_float"], *ref["uniform"].values()])

    def gain(s):
        return (rows[s]["damage_4b"] - rows[s]["damage_8b"]) / (4 * rows[s]["numel"])

    def slack(s):
        return 2 * eps / (4 * rows[s]["numel"])

    ties = []
    for s, b in ref["assignment"].items():
        if got["assignment"][s] == b:
            continue
        near = [t for t, bt in ref["assignment"].items()
                if bt != b and abs(gain(s) - gain(t)) <= slack(s) + slack(t)]
        if not near:
            raise AssertionError(f"[tooling] the card planned {s} at {got['assignment'][s]} "
                                 f"bits, the CPU at {b}, with no near tie")
        ties.append([s, near[0]])
    return ties


class _ActHandover:
    """Deviation 14's hand-over for a QAT model's activation quantizers
    across whole sequences of evaluations (the copies a plan makes carry the
    hooks).  ``record``: each ``act_fq``'s input elements within 1e-3 of a
    rounding boundary of its quantizer, kept on the host by call.  ``take``
    (the other device, the same sequence of calls): where such an element
    quantizes to another level than the recorded one, the recorded value is
    handed over and counted; an element away from a boundary cannot change
    its level by a rounding difference."""

    NEAR = 1e-3

    def __init__(self, torch, model, take=None):
        self.torch, self.take = torch, take
        self.kept = {} if take is None else None
        self.calls = {}
        self.moved = [0, 0]
        self.hooks = [m.register_forward_pre_hook(
            lambda mod, args, n=n: self._pre(n, mod, args))
            for n, m in model.named_modules() if n.endswith("act_fq")]

    def _v(self, mod, x):
        torch = self.torch
        spec = mod.cfg.spec
        s = mod.scale.detach().abs().clamp_min(torch.finfo(torch.float32).eps)
        zp = torch.round(torch.clamp(-mod.shift.detach() / s, spec.type_min, spec.type_max))
        return torch.clamp(x / s + zp, spec.quant_min, spec.quant_max)

    def _pre(self, n, mod, args):
        torch = self.torch
        x = args[0].detach()
        i = self.calls[n] = self.calls.get(n, -1) + 1
        if self.take is None:
            v = self._v(mod, x).reshape(-1)
            idx = ((v - torch.floor(v) - 0.5).abs() < self.NEAR).nonzero().reshape(-1)
            self.kept.setdefault(n, []).append((idx.cpu(), x.reshape(-1)[idx].cpu()))
            return None
        idx, vals = self.take.kept[n][i]
        idx, vals = idx.to(x.device), vals.to(x.device)
        flat = x.reshape(-1).clone()
        far = torch.round(self._v(mod, flat[idx])) != torch.round(self._v(mod, vals))
        self.moved[0] += int(far.sum())
        self.moved[1] += flat.numel()
        flat[idx[far]] = vals[far]
        return (flat.reshape(x.shape),) + tuple(args[1:])

    def close(self):
        for h in self.hooks:
            h.remove()


def _tool_plan(torch, card, fq):
    """sensitivity_report and plan_mixed_precision (weights at 4 or 8 bits,
    TOOL_TARGET average) on the card at B = MNV2_B; then both on the card and
    on the CPU from the same state on the batch's first TOOL_CPU_B images:
    every loss within TOOL_REL relative, the assignments equal but at near
    ties, the CPU's activation-quantizer inputs handed over where the card's
    quantize to the neighbouring level (deviation 14, at most
    MAX_DECODE_MOVED of them); every quantizer tensor bit-identical after
    each call."""
    from jaxlsq_torch.utils import plan_mixed_precision, sensitivity_report

    model, batch, _ = _tool_mnv2(torch, _combo_qc(4, 1200), seed=181)
    model.eval()
    before = _quantizer_state(model)
    f0 = dict(fq)
    s = time.time()
    sens = sensitivity_report(model, batch, input_key="image")
    _unchanged(torch, model, before, "sensitivity_report")
    sens_s, s = time.time() - s, time.time()
    plan = plan_mixed_precision(model, batch, bit_options=(4, 8),
                                target_avg_bits=TOOL_TARGET, input_key="image", verify=True)
    _unchanged(torch, model, before, "plan_mixed_precision")
    plan_s = time.time() - s
    launches = {k: fq[k] - f0[k] for k in FQ_KERNELS}
    if launches["fq_fwd_pt"] <= 0 or launches["fq_fwd_pc"] <= 0:
        raise AssertionError(f"[tooling] the evaluations launched {launches}")
    n8 = sum(1 for b in plan["assignment"].values() if b == 8)
    log(f"[tooling] w4a8 mobilenetv2_cifar, B={MNV2_B}: sensitivity_report over "
        f"{len(sens['rows'])} layers in {sens_s:.2f} s (float loss "
        f"{sens['baseline_float']:.5f}, all quantized {sens['baseline_quant']:.5f}, most "
        f"sensitive {sens['rows'][0]['scope']}); plan_mixed_precision (4, 8) at "
        f"{TOOL_TARGET}: {n8} of {len(plan['assignment'])} layers at 8 bits, avg "
        f"{plan['avg_bits']:.3f}, planned loss {plan['planned_quant_loss']:.5f} "
        f"(uniform {plan['uniform']}) in {plan_s:.2f} s; fake-quant launches {launches}; "
        "every quantizer tensor unchanged after each")
    small = {k: v[:TOOL_CPU_B] for k, v in batch.items()}
    cpu_model = _mnv2(torch, "cpu", wbits=4, window=1200)
    cpu_model.load_state_dict(model.state_dict())
    cpu_model.eval()
    cpu_before = _quantizer_state(cpu_model)
    plans, losses, hand, cpu_s = {}, {}, None, None
    for m, batch_d in ((model, small), (cpu_model, {k: v.cpu() for k, v in small.items()})):
        s = time.time()
        dev = next(m.parameters()).device.type
        hand = _ActHandover(torch, m, take=hand)  # the CPU takes the card's near-boundary inputs
        try:
            plans[dev] = plan_mixed_precision(m, batch_d, bit_options=(4, 8),
                                              target_avg_bits=TOOL_TARGET, input_key="image")
            losses[dev] = _losses(sensitivity_report(m, batch_d, input_key="image"),
                                  plans[dev])
        finally:
            hand.close()
        cpu_s = time.time() - s
    got, want, plan_card, plan_cpu = losses["cuda"], losses["cpu"], plans["cuda"], plans["cpu"]
    _unchanged(torch, model, before, "the B=8 calls")
    _unchanged(torch, cpu_model, cpu_before, "the CPU calls")
    worst = max(want, key=lambda k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30))
    rel = abs(got[worst] - want[worst]) / max(abs(want[worst]), 1e-30)
    ties = _near_ties(plan_cpu, plan_card, TOOL_REL)
    log(f"[tooling] card vs CPU on {TOOL_CPU_B} images: {len(want)} losses, the worst "
        f"{worst} {rel:.3e} relative (tol {TOOL_REL}; {hand.moved[0]} of {hand.moved[1]} "
        f"activation-quantizer inputs handed over); assignments equal but {len(ties)} "
        f"near ties {ties}; the CPU calls {cpu_s:.1f} s")
    if not rel <= TOOL_REL or hand.moved[0] > MAX_DECODE_MOVED * hand.moved[1]:
        raise AssertionError(f"[tooling] card and CPU losses disagree: {worst} {rel}")
    return model, plan, {"sensitivity_s": sens_s, "plan_s": plan_s, "fq_launches": launches,
                         "n_int8": n8, "n_layers": len(plan["assignment"]),
                         "avg_bits": plan["avg_bits"], "planned_loss": plan["planned_quant_loss"],
                         "uniform": plan["uniform"], "baseline_float": sens["baseline_float"],
                         "cpu_vs_card_rel": rel, "cpu_vs_card_worst": worst,
                         "handed_over": hand.moved, "near_ties": ties, "cpu_s": cpu_s}


def _tool_mixed(torch, plan, card, mm, fq):
    """The plan's qconfig: a fresh mobilenetv2_cifar calibrated and trained
    as the planned one (StepTimer's rate), converted and served (phase 13's
    rules, the classifier through the wo kernel of its planned width, the
    convolutions' packs at both widths), and serving_size_report beside the
    uniform w4 and w8 conversions of the same variables."""
    from jaxlsq_torch import interop
    from jaxlsq_torch.models import mobilenetv2_cifar
    from jaxlsq_torch.models.layers import _PackedBuffers
    from jaxlsq_torch.utils import serving_size_report

    qc = plan["qconfig"]
    model, batch, rate = _tool_mnv2(torch, qc, seed=182)
    out = {"steps_per_s": rate}
    out["serve"] = _mnv2_serve(torch, model, plan["assignment"]["classifier"],
                               batch["image"], mm, fq)
    tree = interop.qat_variables(model)
    sizes = {}
    for name, wbits in (("planned", None), ("uniform_w4", 4), ("uniform_w8", 8)):
        q = qc if wbits is None else _combo_qc(wbits, 1200)
        served = mobilenetv2_cifar(MNV2_CLASSES, q.for_serving("static"), device="cuda")
        interop.load_variables(served, tree)
        sizes[name] = serving_size_report(served)
        if wbits is None:
            bits = [m.bits for m in served.modules() if isinstance(m, _PackedBuffers)]
            out["packs_by_bits"] = {8: bits.count(8), 4: bits.count(4)}
    out["serving_size"] = sizes
    log(f"[tooling] the planned mobilenetv2_cifar: {TOOL_STEPS} captured steps at "
        f"{rate * MNV2_B:.0f} images/s (StepTimer), packs by width "
        f"{out['packs_by_bits']}; serving_size_report: " + "; ".join(
            f"{k} {v['total_bytes']} bytes ({v['compression']}x)" for k, v in sizes.items()))
    if not (sizes["uniform_w4"]["total_bytes"] < sizes["planned"]["total_bytes"]
            < sizes["uniform_w8"]["total_bytes"]) or 0 in out["packs_by_bits"].values():
        raise AssertionError(f"[tooling] the planned packs are not mixed: {out}")
    return out


def _tool_mixed_lm(torch, card, mm):
    """Mixed carriers on the dense path: phase 3's LM in QAT mode at w4 (full
    range), calibrated on 4 token batches, planned (4, 8) at TOOL_TARGET on a
    B = 8, t = 47 batch; the planned copy converted and served 'static': its
    logits within 1e-4 of max|ref| of the planned QAT model's eval logits
    (deviation 14's hand-over), and ``make_generate`` at B = 1 through both
    ``wo8`` and ``wo4``."""
    from jaxlsq_torch import interop
    from jaxlsq_torch.models import (QuantDense, QuantTransformerLM, calibrate,
                                     default_qconfig)
    from jaxlsq_torch.parallel import make_eval_step
    from jaxlsq_torch.serve import make_generate
    from jaxlsq_torch.utils import plan_mixed_precision

    qc = default_qconfig(4, 8, per_channel_weights=True, init_batches=1, reduce_range=False)
    qat = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, qc, max_len=TOOL_LM_LEN,
                             device="cuda", seed=18)
    g = torch.Generator(device="cuda").manual_seed(183)
    calibrate(qat, [torch.randint(0, VOCAB, (4, 48), device="cuda", generator=g)
                    for _ in range(4)])
    toks = torch.randint(0, VOCAB, (8, 48), device="cuda", generator=g)
    plan = plan_mixed_precision(qat, {"input": toks[:, :-1], "label": toks[:, 1:]},
                                bit_options=(4, 8), target_avg_bits=TOOL_TARGET)
    planned = plan["planned_model"]
    served = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, plan["qconfig"].for_serving("static"),
                                max_len=TOOL_LM_LEN, device="cuda")
    interop.load_variables(served, interop.qat_variables(planned))
    prompt = toks[:2, :40]
    ref_inputs = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, n=n: ref_inputs.setdefault(n, []).append(args[0].detach().clone()))
        for n, m in planned.named_modules() if isinstance(m, QuantDense)]
    try:
        want = make_eval_step(planned)({"input": prompt})
    finally:
        for h in hooks:
            h.remove()
    hand = _Handover(torch, served)
    hand.ref = ref_inputs
    with torch.no_grad():
        got = hand.run(lambda: served(prompt), take=True)
    err = float((got - want).abs().max())
    tol = 1e-4 * float(want.abs().max())
    before = dict(mm)
    toks_out = make_generate(served, EXPORT_T0, EXPORT_NEW)(prompt[:1, :EXPORT_T0])
    launches = {k: mm[k] - before[k] for k in ("wo8", "wo4")}
    dense = {n: b for n, b in plan["assignment"].items() if n != "tok_emb"}
    out = {"assignment": plan["assignment"], "avg_bits": plan["avg_bits"],
           "logits_err": err, "tol": tol, "moved": hand.moved, "generate_launches": launches}
    log(f"[tooling] the d1024x4 LM at w4, planned (4, 8) at {TOOL_TARGET}: "
        f"{sum(b == 8 for b in dense.values())} of {len(dense)} dense layers at 8 bits "
        f"(avg {plan['avg_bits']:.3f}); served 'static' logits vs the planned QAT model's eval "
        f"logits max_abs_err {err:.3e} (tol {tol:.3e}; {hand.moved[0]} of {hand.moved[1]} "
        f"layer inputs handed over); make_generate B=1 launched {launches}")
    if not (err <= tol and hand.moved[0] <= MAX_DECODE_MOVED * hand.moved[1]):
        raise AssertionError(f"[tooling] the planned LM's served logits: {err} > {tol} or "
                             f"{hand.moved} moved")
    if min(launches.values()) <= 0 or toks_out.shape != (1, EXPORT_NEW):
        raise AssertionError(f"[tooling] the mixed LM did not run both wo kernels: {launches}")
    return out


_REPLAY = r'''
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
import jaxlsq_torch.serve.custom_ops  # noqa: F401  (registers the operators)
from torch.profiler import ProfilerActivity, profile

mm = sys.modules["jaxlsq_torch.serve.matmul"].LAUNCHES
attn = sys.modules["jaxlsq_torch.serve.attention"].LAUNCHES
results = {}
for case in json.loads(sys.argv[2]):
    args = torch.load(case["args"], map_location="cuda")
    program = torch.export.load(case["blob"]).module()
    before = {**mm, **attn}
    out = program(args["state"], args["x"])
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in {**mm, **attn}.items() if v != before[k]}
    names = set()
    for _ in range(3):  # the profiler can lose a stretch of kernel records
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            program(args["state"], args["x"])
            torch.cuda.synchronize()
        names = {e.key for e in p.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if any(k in n for n in names for k in case["kernels"]):
            break
    results[case["name"]] = {
        "equal": bool(torch.equal(out, args["ref"])), "launches": launches,
        "kernels": sorted(n for n in names if any(k in n for k in case["kernels"]))}
bad = sorted(m for m in sys.modules if m.startswith(("jaxlsq_torch.models",
             "jaxlsq_torch.interop")) or m.split(".")[0] in ("jax", "jaxlsq", "flax"))
print(json.dumps({"results": results, "model_modules": bad}))
'''


def _tool_export(torch, card):
    """torch.export of phase 3's d1024 x 4 LM at w8 and w4 (f32 cache, B = 1):
    the serving forward and the greedy generate (prompt EXPORT_T0, EXPORT_NEW
    new tokens), and the 'static_int8' forward; each blob under
    EXPORT_MAX_BLOB, replayed in a fresh process that imports torch and
    ``serve.custom_ops`` only: bit-equal to the eager forward and
    ``make_generate``, launching the hand-written kernels (their counts and
    the profiler's kernel names)."""
    import shutil
    import tempfile

    from jaxlsq_torch import interop
    from jaxlsq_torch.models import QuantTransformerLM, default_qconfig, init_variables
    from jaxlsq_torch.serve import export_generate, export_serving_forward, make_generate
    from jaxlsq_torch.serve.matmul import FUSED_MAX_M

    fused = EXPORT_T0 <= FUSED_MAX_M
    d = tempfile.mkdtemp(prefix="jlt_export_")
    g = torch.Generator(device="cuda").manual_seed(184)
    prompt = torch.randint(0, VOCAB, (1, EXPORT_T0), device="cuda", generator=g,
                           dtype=torch.int32)
    max_len = EXPORT_T0 + EXPORT_NEW
    cases, out = [], {}
    wo = ("wo_mma_", "wo_split_kernel", "wo_tiled_kernel")
    for name, wbits, act_mode in (("w8", 8, "none"), ("w4", 4, "none"),
                                  ("w8_static_int8", 8, "static_int8")):
        qc = default_qconfig(wbits, 8, per_channel_weights=True).for_serving(act_mode)
        model = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, qc, max_len=max_len,
                                   device="cuda")
        interop.load_variables(model, init_variables(model, seed=40 + wbits))
        model.eval()
        state = dict(model.state_dict())
        progs = [("forward", lambda: export_serving_forward(model, state, prompt), prompt)]
        if act_mode == "none":
            progs.append(("generate", lambda: export_generate(
                model, state, EXPORT_T0, EXPORT_NEW, batch_size=1), prompt))
        for prog, export, x in progs:
            s = time.time()
            blob = export()
            export_s = time.time() - s
            with torch.no_grad():
                ref = (model(x) if prog == "forward"
                       else make_generate(model, EXPORT_T0, EXPORT_NEW)(x))
            key = f"{name}_{prog}"
            path = os.path.join(d, key)
            with open(path + ".pt2", "wb") as f:
                f.write(blob)
            torch.save({"state": state, "x": x, "ref": ref}, path + ".args")
            # an EXPORT_T0-row forward's int8 layers quantize in i8mm itself up
            # to FUSED_MAX_M rows, else by act_quant_i8 first
            kernels = ((("i8mm_kernel",) if fused else ("act_quant", "i8mm_kernel"))
                       if act_mode == "static_int8" else wo)
            if prog == "generate":
                kernels = kernels + ("decode_attention_span_kernel",)
            cases.append({"name": key, "blob": path + ".pt2", "args": path + ".args",
                          "kernels": list(kernels)})
            out[key] = {"blob_bytes": len(blob), "export_s": export_s}
            if len(blob) >= EXPORT_MAX_BLOB:
                raise AssertionError(f"[tooling] the {key} blob is {len(blob)} bytes")
        del model
    s = time.time()
    proc = subprocess.run([sys.executable, "-c", _REPLAY, ROOT, json.dumps(cases)],
                          capture_output=True, text=True, timeout=900)
    replay_s = time.time() - s
    shutil.rmtree(d)
    if proc.returncode != 0:
        raise AssertionError(f"[tooling] the replay process failed:\n{proc.stderr[-4000:]}")
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    for key, r in rep["results"].items():
        out[key].update(r)
        want = ((({"i8mm", "i8mm_fused"} if fused else {"act_quant_i8", "i8mm"})
                 if "int8" in key else {"wo8" if key.startswith("w8") else "wo4"}))
        if "generate" in key:
            want |= {"decode_attention"}
        launches = r["launches"]
        once = "int8" not in key or (  # every i8mm's rows quantized once
            launches.get("act_quant_i8", 0) + launches.get("i8mm_fused", 0)
            == launches["i8mm"])
        if not r["equal"] or not want <= set(r["launches"]) or not r["kernels"] \
                or not once:
            raise AssertionError(f"[tooling] the replayed {key}: {r}")
    if rep["model_modules"]:
        raise AssertionError(f"[tooling] the replay process imported {rep['model_modules']}")
    out["replay_s"] = replay_s
    log(f"[tooling] torch.export of the d1024x4 LM (B=1, f32 cache; generate {EXPORT_T0} + "
        f"{EXPORT_NEW}): " + "; ".join(
            f"{k} {v['blob_bytes']} bytes, exported in {v['export_s']:.1f} s, replay bit-equal, "
            f"launches {v['launches']}, profiled {v['kernels']}" for k, v in out.items()
            if isinstance(v, dict))
        + f"; the replay process ({replay_s:.1f} s) imported no model class")
    return out


def _mt19937_64(seed):
    """std::mt19937_64 seeded with one 64-bit value: its next output."""
    mask = (1 << 64) - 1
    mt = [seed & mask]
    for i in range(1, 312):
        mt.append((6364136223846793005 * (mt[-1] ^ (mt[-1] >> 62)) + i) & mask)
    state = {"i": 312}

    def draw():
        if state["i"] >= 312:
            for i in range(312):
                x = (mt[i] & 0xFFFFFFFF80000000) | (mt[(i + 1) % 312] & 0x7FFFFFFF)
                mt[i] = mt[(i + 156) % 312] ^ (x >> 1) ^ (0xB5026F5AA96619E9 if x & 1 else 0)
            state["i"] = 0
        y = mt[state["i"]]
        state["i"] += 1
        y ^= (y >> 29) & 0x5555555555555555
        y ^= (y << 17) & 0x71D67FFFEDA60000
        y ^= (y << 37) & 0xFFF7EEE000000000
        return (y ^ (y >> 43)) & mask

    return draw


def _loader_rows(n, seed, batch, k):
    """The loader's contract: batch ``k`` holds rows perm_epoch[k*B:(k+1)*B]
    of the (shard, row) index, the epoch's permutation a Fisher-Yates shuffle
    of the identity by std::mt19937_64 seeded ``seed * 0x9E3779B97F4A7C15 +
    epoch``; epochs drop their remainder."""
    per_epoch = n // batch
    epoch, off = divmod(k, per_epoch)
    draw = _mt19937_64((seed * 0x9E3779B97F4A7C15 + epoch) & ((1 << 64) - 1))
    perm = list(range(n))
    for i in range(n - 1, 0, -1):
        j = draw() % (i + 1)
        perm[i], perm[j] = perm[j], perm[i]
    return perm[off * batch:(off + 1) * batch]


def _tool_oracle(torch):
    """The host C++ oracle against the card's fake-quant kernels (phase 2's
    gates) at a per-tensor activation and a per-channel weight, in train,
    eval and init modes."""
    import numpy as np

    from jaxlsq_torch.core.golden import effective_grad_scale
    from jaxlsq_torch.core.spec import QuantSpec
    from jaxlsq_torch.native import native_backward, native_forward
    from jaxlsq_torch.ops.fake_quant import fake_quant_backward, fake_quant_forward

    g = torch.Generator(device="cuda").manual_seed(185)
    cases = [("activation", (32, 64, 16, 16), QuantSpec.activation_default(8)),
             ("weight", (256, 128, 3, 3), QuantSpec.weight_default(8, per_channel=True,
                                                                    axis=0))]
    out = {"oracle": {}}
    for what, shape, spec in cases:
        x = torch.randn(shape, device="cuda", generator=g) * 2
        gr = torch.randn(shape, device="cuda", generator=g)
        c = shape[0] if spec.per_channel else 1
        s = torch.rand(c, device="cuda", generator=g) * 0.03 + 0.02
        b = (torch.zeros(c, device="cuda") if spec.symmetric
             else torch.randn(c, device="cuda", generator=g) * 0.1)
        npx, npg, nps, npb = (t.cpu().numpy() for t in (x, gr, s, b))
        for ev, init in ((False, False), (True, False), (False, True)):
            fwd = fake_quant_forward(x, s, b, spec, init_mode=init)
            dx, ds, db = fake_quant_backward(gr, x, s, b, spec, eval_mode=ev, init_mode=init)
            nf = native_forward(npx, nps, npb, spec, init_mode=init)
            ndx, nds, ndb = native_backward(npg, npx, nps, npb, spec, eval_mode=ev,
                                            init_mode=init)
            gs = effective_grad_scale(spec, x.numel(), c)
            ts, tb = _fq_term_sums(torch, gr, x, s, b, spec, init, gs)
            e_s = float((ds.double().cpu() - torch.from_numpy(nds).double()).abs().max())
            e_b = float((db.double().cpu() - torch.from_numpy(ndb).double()).abs().max())
            ok = (np.array_equal(fwd.cpu().numpy(), nf) and np.array_equal(dx.cpu().numpy(), ndx)
                  and bool(((ds.double().cpu() - torch.from_numpy(nds).double()).abs()
                            <= 1e-5 * ts.cpu()).all())
                  and bool(((db.double().cpu() - torch.from_numpy(ndb).double()).abs()
                            <= 1e-5 * tb.cpu()).all()))
            out["oracle"][f"{what} eval={ev} init={init}"] = {"ds_err": e_s, "db_err": e_b}
            if not ok:
                raise AssertionError(f"[tooling] the native oracle and the card disagree at "
                                     f"{what} eval={ev} init={init}: dS {e_s}, dB {e_b}")
    log(f"[tooling] the native oracle against fq_fwd/bwd_pt and _pc: forward and dX bit for "
        f"bit, dS/dB within 1e-5 of their term sums ({out['oracle']})")
    return out


def _tool_loader(torch):
    """NativeShardLoader feeding LOADER_STEPS eager resnet18_cifar steps at
    B = LOADER_B from shards written from a seed, each batch the rows the
    loader's contract names."""
    import shutil
    import tempfile

    import numpy as np

    from jaxlsq_torch.native import NativeShardLoader
    from jaxlsq_torch.parallel import make_train_step

    d = tempfile.mkdtemp(prefix="jlt_shards_")
    r = np.random.RandomState(186)
    shards, xs, ys = [], [], []
    for i, n in enumerate(LOADER_SHARDS):
        x = r.randn(n, 3, 32, 32).astype(np.float32)
        y = r.randint(0, 10, n).astype(np.int64)
        np.save(os.path.join(d, f"x{i}.npy"), x)
        np.save(os.path.join(d, f"y{i}.npy"), y)
        shards.append((os.path.join(d, f"x{i}.npy"), os.path.join(d, f"y{i}.npy")))
        xs.append(x)
        ys.append(y)
    xs, ys = np.concatenate(xs), np.concatenate(ys)
    model = _resnet(torch, "cuda", seed=7)
    step = make_train_step(model, _sgd(torch, model), jit=False)
    losses = []
    with NativeShardLoader(shards, LOADER_B, seed=3, workers=4, prefetch=4,
                           device="cuda") as ld:
        for k in range(LOADER_STEPS):
            x, y = ld.next()
            rows = _loader_rows(len(xs), 3, LOADER_B, k)
            if not (x.is_cuda and np.array_equal(x.cpu().numpy(), xs[rows])
                    and np.array_equal(y.cpu().numpy(), ys[rows])):
                raise AssertionError(f"[tooling] loader batch {k} is not the contract's rows")
            losses.append(float(step({"image": x, "label": y})["loss"]))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"[tooling] non-finite losses {losses}")
    shutil.rmtree(d)
    out = {"losses": losses, "batches_per_epoch": len(xs) // LOADER_B}
    log(f"[tooling] NativeShardLoader ({len(xs)} rows in {len(shards)} shards, 4 workers): "
        f"{LOADER_STEPS} eager resnet18_cifar steps at B={LOADER_B}, every batch the "
        f"contract's rows (a re-derived mt19937_64 shuffle); losses {losses}")
    return out


def phase_tooling(torch, rec):
    """Phase 18, inside ``utils.profiling.trace``: sensitivity and planning on
    mobilenetv2 (card against the CPU), mixed carriers served (mobilenetv2 and
    the d1024 LM), torch.export of the d1024 LM replayed in a fresh process,
    with every count at 0; then the native oracle and shard loader.  Each
    leg is an ``annotate`` span, found in the trace file after."""
    import shutil
    import tempfile

    from jaxlsq_torch.utils import annotate, trace

    out = rec["tooling"] = {}
    t_start = time.time()
    log_dir = tempfile.mkdtemp(prefix="jlt_trace_")
    legs = out["leg_s"] = {}
    mm, attn, fq = reset_counts()
    with trace(log_dir) as prof:
        s = time.time()
        with annotate("jlt/plan"):
            model, plan, out["plan"] = _tool_plan(torch, rec["card"], fq)
        legs["plan"], s = time.time() - s, time.time()
        with annotate("jlt/mixed"):
            out["mixed"] = _tool_mixed(torch, plan, rec["card"], mm, fq)
            out["mixed_lm"] = _tool_mixed_lm(torch, rec["card"], mm)
        legs["mixed"], s = time.time() - s, time.time()
        with annotate("jlt/export"):
            out["export"] = _tool_export(torch, rec["card"])
        legs["export"], s = time.time() - s, time.time()
        with annotate("jlt/native"):
            torch.cuda.synchronize()
            pre = {**fq, **mm, **attn}
            out["native"] = _tool_oracle(torch)  # its launches compare: not counted
            torch.cuda.synchronize()
            post = {**fq, **mm, **attn}
            out["native"]["loader"] = _tool_loader(torch)
            torch.cuda.synchronize()
        legs["native"] = time.time() - s
    out["launches"] = {k: v - (post[k] - pre[k]) for k, v in {**fq, **mm, **attn}.items()}
    s = time.time()
    with open(prof.trace_path) as f:
        spans = {e.get("name") for e in json.load(f).get("traceEvents", [])}
    out["trace_mb"] = os.path.getsize(prof.trace_path) / 1e6
    shutil.rmtree(log_dir)
    legs["trace_file"] = time.time() - s
    missing = {"jlt/plan", "jlt/mixed", "jlt/export", "jlt/native"} - spans
    if missing:
        raise AssertionError(f"[tooling] the trace file lacks the spans {missing}")
    for k in FQ_KERNELS + TRACED_KERNELS + ("wo8", "wo4", "decode_attention"):
        if out["launches"][k] <= 0:
            raise AssertionError(f"kernel {k} was never launched on the tooling path")
    out["wall_s"] = time.time() - t_start
    log(f"[tooling] kernel launches on the tooling path: {out['launches']}; the trace "
        f"({out['trace_mb']:.1f} MB) holds the four annotate spans; phase 18 took "
        f"{out['wall_s']:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in legs.items()) + ")")


def _int8_kernels_line(rec):
    o = rec["int8_moe"]
    m1 = o["times"]["by_m"][1]
    m256 = o["times"]["by_m"][256]
    out = []
    for name, key, repl in (
            ("act_quant_i8", "i1", "none (port-only; jaxlsq/serve/matmul.py:448-451 and "
                                   ":597-600, the activation quantization of "
                                   "static_int8_matmul and dynamic_int8_matmul, XLA)"),
            ("i8mm", "i2", "none (port-only; jaxlsq/serve/matmul.py:415 static_int8_matmul, "
                           ":471 static_int8_conv, :582 dynamic_int8_matmul, "
                           "jaxlsq/models/moe.py:204 _ExpertDense._serve_int8: "
                           "jax.lax.dot / conv_general_dilated in int32, XLA)")):
        out.append({"name": name, "route": "cuda", "source": "jaxlsq_torch/csrc/int8_matmul.cu",
                    "replaces": repl, "launches": o["launches"][name],
                    "tooling_launches": rec["tooling"]["launches"][name],
                    "max_abs_err": rec["max_abs_err"][name], "ms": m1[f"{key}_ms"],
                    "plain_ms": m1[f"{key}_plain_ms"], "bound_ms": m1[f"{key}_bound_ms"],
                    "bound_by": "bytes",
                    "library_ms": m1["i1_library_ms"] if name == "act_quant_i8" else None,
                    "by_m": {m: v for m, v in o["times"]["by_m"].items()},
                    "library_ms_m256": m256["int_mm_ms"] if name == "i8mm" else None,
                    "fused_launches": o["launches"]["i8mm_fused"] if name == "i8mm" else None,
                    "shape": "M=1, sum over qkv/proj/mlp_up/mlp_down/lm_head of the d1024 LM; "
                             + ("library: torch.quantize_per_tensor to quint8"
                                if name == "act_quant_i8" else
                                "library: torch._int_mm (refuses M<=16; by_m at M=256); "
                                "fused_launches: those of the launches that quantized "
                                "their rows themselves")})
    return out


def _obs_kernels_line(rec):
    o = rec["observers"]
    big = max(o["times"]["rows"], key=lambda r: r["elements"])
    out = []
    for name, repl in (
            ("mse_range", "none (port-only; jaxlsq runs MSEObserver._best_range, "
                          "jaxlsq/observers/minmax.py:145, as XLA behind a lax.cond)"),
            ("hist_update", "none (port-only; jaxlsq/observers/histogram.py:123 "
                            "HistogramObserver.update, XLA)"),
            ("hist_search", "none (port-only; jaxlsq/observers/histogram.py:184 "
                            "_search, an XLA while_loop)")):
        b_ms, b_by = big["bounds"][name]
        out.append({"name": name, "route": "cuda", "source": "jaxlsq_torch/csrc/observers.cu",
                    "replaces": repl, "launches": o["launches"][name],
                    "max_abs_err": rec["max_abs_err"][name], "ms": big[name + "_ms"],
                    "plain_ms": o["times"]["plain_ms_largest"][name], "bound_ms": b_ms,
                    "bound_by": b_by,
                    "library_ms": o["times"]["library_ms_largest"].get(name),
                    "step_sum_ms": o["times"]["sum_ms"][name],
                    "step_sum_bound_ms": o["times"]["sum_bound_ms"][name],
                    "shape": "x " + "x".join(map(str, big["shape"])) + " (mobilenetv2's "
                             "largest activation, one step's real data); step_sum: the 23 "
                             "activations" + ("; plain: on the CPU (a host loop)"
                                              if name == "hist_search" else "")
                             + ("; library: torch.histc, 2,048 bins, the batch's counts "
                                "alone" if name == "hist_update" else
                                "; library: none (no one PyTorch call computes it)")})
    return out


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
                    "convnet_launches": rec["convnet"]["launches"][name],
                    "third_party_launches": rec["third_party"]["launches"][name],
                    "decode_features_launches": rec["decode_features"]["launches"][name],
                    "int8_moe_launches": rec["int8_moe"]["launches"][name],
                    "tooling_launches": rec["tooling"]["launches"][name],
                    "pipeline_launches": rec["pipeline"]["launches"][name],
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
                "decode_features_launches":
                    rec["decode_features"]["launches"]["paged_attention"],
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
                "decode_features_launches":
                    rec["decode_features"]["launches"]["decode_attention"],
                "int8_moe_launches": rec["int8_moe"]["launches"]["decode_attention"],
                "tooling_launches": rec["tooling"]["launches"]["decode_attention"],
                "pipeline_launches": rec["pipeline"]["launches"]["decode_attention"],
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
                    "convnet_launches": rec["convnet"]["launches"][name],
                    "third_party_launches": rec["third_party"]["launches"][name],
                    "decode_features_launches": rec["decode_features"]["launches"][name],
                    "int8_moe_launches": rec["int8_moe"]["launches"][name],
                    "tooling_launches": rec["tooling"]["launches"][name],
                    "pipeline_launches": rec["pipeline"]["launches"][name],
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
    out.extend(_obs_kernels_line(rec))
    out.extend(_int8_kernels_line(rec))
    return out


MD_STEPS, MD_GLOO_RANKS, MD_GLOO_B = 3, 2, 64
MD_MOE_DEPTH, MD_MOE_B, MD_MOE_T = 2, 4, 128


def _md_counts():
    """The collectives a leg issued (``jaxlsq_torch._dist.COUNTS``), reset."""
    from jaxlsq_torch import _dist

    out = dict(_dist.COUNTS)
    _dist.COUNTS.clear()
    return out


def _md_equal(torch, a, b):
    """The leaves of two ``_train_state`` dicts that are not bit-equal."""
    return [k for k in a if not torch.equal(a[k], b[k])]


def _md_steps(torch, make, batches, mesh=None, sharding=None, jit=False, loss_fn=None):
    """``make()``'s model trained on ``batches`` by ``make_train_step``
    (meshless, or over ``mesh`` with ``sharding``): (losses, state, step)."""
    from jaxlsq_torch.parallel import make_train_step
    from jaxlsq_torch.parallel.placement import gathered_params

    from jaxlsq_torch import _dist

    model = make()
    opt = _sgd(torch, model)
    kw = {} if loss_fn is None else {"loss_fn": loss_fn}
    step = make_train_step(model, opt, jit=jit, mesh=mesh, state_sharding=sharding, **kw)
    losses, step.per_call = [], []
    for b in batches:
        before = sum(_dist.COUNTS.values())
        losses.append(step(b)["loss"])
        step.per_call.append(sum(_dist.COUNTS.values()) - before)
    state = _train_state(model, opt)
    full = gathered_params(model, grad=False) if mesh is not None else {}
    state.update({f"model/{k}": v for k, v in full.items()})
    if full:  # the momentum of a sharded leaf is its shard: compare the params
        state = {k: v for k, v in state.items() if not k.startswith("optim/")}
    return torch.stack(losses), state, step


def _md_replay_profile(torch, step):
    """A replay of a captured step's graph under the profiler: its kernels,
    NCCL kernels and device-to-device copies (at world size 1 NCCL does
    an in-place all-reduce as no device work at all, so none may show)."""
    from torch.profiler import ProfilerActivity, profile

    graph = _graph_of(step)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"kernels": sum(e.count for e in rows),
            "nccl": sum(e.count for e in rows if "nccl" in e.key.lower()),
            "dtod": sum(e.count for e in rows if "dtod" in e.key.lower())}


def _md_dp(torch, rec, mesh, fq, out):
    """resnet18_cifar at B = 64 through the mesh step, eager and captured,
    bit-equal to the meshless step; returns the batches."""
    batches = _image_batches(torch, MD_STEPS, TRAIN_B, seed=191)
    for jit in (False, True):
        reset_counts()
        want = _md_steps(torch, lambda: _resnet(torch, "cuda", seed=0), batches, jit=jit)
        _md_counts()
        for k in fq:
            fq[k] = 0
        got = _md_steps(torch, lambda: _resnet(torch, "cuda", seed=0), batches,
                        mesh=mesh, jit=jit)
        launches = {k: v for k, v in fq.items() if v}
        bad = _md_equal(torch, want[1], got[1])
        if not torch.equal(want[0], got[0]) or bad or not launches:
            raise AssertionError(f"[multi] DP resnet18_cifar jit={jit}: loss equal "
                                 f"{torch.equal(want[0], got[0])}, unequal leaves "
                                 f"{bad[:5]}, launches {launches}")
        leg = {"leaves": len(got[1]), "collectives": _md_counts(),
               "launches": launches, "losses": got[0].tolist()}
        if jit:
            # the collectives are issued at the warm-up and the capture
            # (on the host, NCCL on a capturing stream), none at a replay
            leg["collectives_per_call"] = got[2].per_call
            if not (got[2].per_call[0] == got[2].per_call[1] > 0
                    and not any(got[2].per_call[2:])):
                raise AssertionError(f"[multi] the captured DP step issued "
                                     f"{got[2].per_call} collectives a call")
            leg["replay_profile"] = {"mesh": _md_replay_profile(torch, got[2]),
                                     "meshless": _md_replay_profile(torch, want[2])}
            # a replay's device span, meshless and mesh graphs in turns
            spans = {"meshless": [], "mesh": []}
            for _ in range(10):
                for side, res in (("meshless", want), ("mesh", got)):
                    spans[side].append(events_ms(_graph_of(res[2]).replay)[0])
            leg["replay_ms"] = {k: min(v) for k, v in spans.items()}
        out[f"dp_{'captured' if jit else 'eager'}"] = leg
        log(f"[multi] DP resnet18_cifar B={TRAIN_B}, {MD_STEPS} steps "
            f"{'captured' if jit else 'eager'} over a 1x1 NCCL mesh: every one of "
            f"{leg['leaves']} leaves and the losses bit-equal to the meshless step; "
            f"collectives {leg['collectives']}; launches {launches}"
            + (f"; collectives a call (warm-up, capture, replays) "
               f"{leg['collectives_per_call']}; a replay's profile "
               f"{leg['replay_profile']}; a replay {leg['replay_ms']['mesh']:.3f} ms "
               f"against the meshless {leg['replay_ms']['meshless']:.3f} "
               f"({rec['card']})" if jit else ""))
    return batches


def _md_fsdp(torch, rec, mesh, fq, out, batches):
    """FSDP of a 1024-wide MLP and of resnet18_cifar (on ``batches``),
    eager, bit-equal to the meshless step."""
    from jaxlsq_torch.models import QuantMLP, default_qconfig
    from jaxlsq_torch.parallel import fsdp_sharding

    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=2)
    g = torch.Generator(device="cuda").manual_seed(192)
    mlp_batches = [{"input": torch.randn(TRAIN_B, 1024, device="cuda", generator=g),
                    "label": torch.randint(0, 10, (TRAIN_B,), device="cuda",
                                           generator=g)} for _ in range(MD_STEPS)]
    for name, make, bs in (
            ("mlp", lambda: QuantMLP(1024, (1024, 1024, 10), qc, device="cuda", seed=3),
             mlp_batches),
            ("resnet18_cifar", lambda: _resnet(torch, "cuda", seed=0), batches)):
        want = _md_steps(torch, make, bs)
        _md_counts()
        for k in fq:
            fq[k] = 0
        sharding = fsdp_sharding(mesh, make())
        got = _md_steps(torch, make, bs, mesh=mesh, sharding=sharding)
        launches = {k: v for k, v in fq.items() if v}
        bad = _md_equal(torch, {k: want[1][k] for k in got[1]}, got[1])
        sharded = sum(1 for v in sharding.values() if "Shard" in str(v))
        if not torch.equal(want[0], got[0]) or bad or not sharded or not launches:
            raise AssertionError(f"[multi] FSDP {name}: unequal {bad[:5]}, "
                                 f"{sharded} sharded leaves, launches {launches}")
        out[f"fsdp_{name}"] = {"sharded_leaves": sharded, "collectives": _md_counts(),
                               "launches": launches}
        log(f"[multi] FSDP {name}, {MD_STEPS} eager steps over the 1x1 mesh "
            f"({sharded} leaves sharded): losses and parameters bit-equal to the "
            f"meshless step; collectives {out[f'fsdp_{name}']['collectives']}")


def _md_ep(torch, rec, fq, out):
    """The EP MoE LM of phase 17 at depth 2 over a 1 x 1 (data, expert)
    mesh, eager and captured, bit-equal to the meshless step."""
    from torch.distributed.device_mesh import DeviceMesh

    from jaxlsq_torch.models import QuantTransformerLM, default_qconfig
    from jaxlsq_torch.parallel import moe_sharding

    emesh = DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                       mesh_dim_names=("data", "expert"))
    mqc = default_qconfig(8, 8, per_channel_weights=True, init_batches=1)

    def moe_lm():
        return QuantTransformerLM(VOCAB, DIM, MD_MOE_DEPTH, HEADS, mqc, max_len=MD_MOE_T,
                                  device="cuda", moe_experts=MOE_E, moe_top_k=MOE_TOP_K,
                                  moe_capacity_factor=MOE_CF, seed=19)

    g = torch.Generator(device="cuda").manual_seed(193)
    moe_batches = []
    for _ in range(MD_STEPS):
        x = torch.randint(0, VOCAB, (MD_MOE_B, MD_MOE_T + 1), device="cuda", generator=g)
        moe_batches.append({"input": x[:, :-1].contiguous(),
                            "label": x[:, 1:].contiguous()})
    for jit in (False, True):
        want = _md_steps(torch, moe_lm, moe_batches, jit=jit)
        _md_counts()
        for k in fq:
            fq[k] = 0
        model = moe_lm()
        got = _md_steps(torch, moe_lm, moe_batches, mesh=emesh, jit=jit,
                        sharding=moe_sharding(emesh, model, MOE_E))
        del model
        launches = {k: v for k, v in fq.items() if v}
        bad = _md_equal(torch, want[1], got[1])
        if not torch.equal(want[0], got[0]) or bad or not launches:
            raise AssertionError(f"[multi] EP MoE LM jit={jit}: unequal {bad[:8]}, "
                                 f"losses {want[0].tolist()} {got[0].tolist()}")
        leg = {"collectives": _md_counts(), "launches": launches,
               "losses": got[0].tolist(), "leaves": len(got[1])}
        out[f"ep_{'captured' if jit else 'eager'}"] = leg
        log(f"[multi] EP d1024 x {MD_MOE_DEPTH} MoE LM ({MOE_E} experts, B={MD_MOE_B}, "
            f"t={MD_MOE_T}) {'captured' if jit else 'eager'} over a 1x1 (data, expert) "
            f"NCCL mesh, {MD_STEPS} steps: every one of {leg['leaves']} leaves and the "
            f"losses bit-equal to the meshless step; collectives {leg['collectives']}; "
            f"launches {launches}")


def _md_tp(torch, rec, mesh, out):
    """Phase 3's d1024 x 4 LM served under ``shard_converted``: tokens
    equal to the meshless model's at w8 (dense and paged int8 caches), w4,
    group-wise int4 and w8 ``'static_int8'`` (dense cache)."""
    import copy

    from jaxlsq_torch import interop
    from jaxlsq_torch.models import QuantTransformerLM
    from jaxlsq_torch.serve import make_generate, shard_converted
    from jaxlsq_torch.serve.paged import LAUNCHES as PAGED

    r = torch.Generator(device="cuda").manual_seed(194)
    prompt = torch.randint(0, VOCAB, (4, T0), device="cuda", generator=r)
    legs = {}
    for name, wbits, group, act in (("w8", 8, None, "none"), ("w4", 4, None, "none"),
                                    ("w4g", 4, GROUP, "none"),
                                    ("w8_static_int8", 8, None, "static_int8")):
        model, variables, qc = _lm(torch, wbits, T0 + 64, seed=0, group=group)
        if act != "none":
            model = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, qc.for_serving(act),
                                       max_len=T0 + 64, device="cuda")
            interop.load_variables(model, variables)
        tp = copy.deepcopy(model)
        shard_converted(tp, mesh)
        want = make_generate(model, T0, 32)(prompt)
        mm, attn, _ = reset_counts()
        _md_counts()
        got = make_generate(tp, T0, 32)(prompt)
        leg = {"collectives": _md_counts(),
               "launches": {k: v for c in (mm, attn) for k, v in c.items() if v}}
        equal = torch.equal(want, got)
        if name == "w8":
            want_p = _paged_generate(torch, model, prompt, 32, PAGE)
            reset_counts()
            got_p = _paged_generate(torch, tp, prompt, 32, PAGE)
            leg["paged_collectives"] = _md_counts()
            leg["paged_launches"] = {k: v for k, v in PAGED.items() if v}
            equal = equal and torch.equal(want_p, got_p)
        if not equal or not leg["launches"]:
            raise AssertionError(f"[multi] TP generate {name}: tokens differ from the "
                                 f"meshless model's; {leg}")
        legs[name] = leg
        log(f"[multi] TP d1024 x {DEPTH} LM {name} under shard_converted over the 1x1 "
            f"mesh: make_generate B=4 {T0}+32 tokens equal to the meshless model's"
            + (" with the dense and the paged int8 cache" if name == "w8" else "")
            + f"; collectives {leg['collectives']}"
            + (f" / {leg['paged_collectives']}" if name == "w8" else "")
            + f"; launches {leg['launches']}"
            + (f" / {leg['paged_launches']}" if name == "w8" else ""))
        del model, tp
    out["tp"] = legs


def phase_multi_device(torch, rec):
    """Phase 19: the multi-device steps at world size 1 on NCCL (bit-equal to
    the meshless ones), then two gloo ranks on the one card."""
    from jaxlsq_torch.parallel import initialize_distributed, make_mesh

    t0 = time.time()
    out = {}
    rec["multi_device"] = out
    port = _free_port()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
                      WORLD_SIZE="1", LOCAL_RANK="0")
    rank, world = initialize_distributed()
    import torch.distributed as dist

    if (rank, world) != (0, 1) or dist.get_backend() != "nccl":
        raise AssertionError(f"[multi] bring-up gave rank {rank} of {world} on "
                             f"{dist.get_backend()}")
    mesh = make_mesh()
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    _, _, fq = reset_counts()
    _md_counts()
    try:
        batches = _md_dp(torch, rec, mesh, fq, out)
        _md_fsdp(torch, rec, mesh, fq, out, batches)
        _md_ep(torch, rec, fq, out)
        _md_tp(torch, rec, mesh, out)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        dist.destroy_process_group()
        for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
            os.environ.pop(k, None)
    out["nccl_s"] = time.time() - t0
    out["gloo"] = _md_gloo(torch, rec)
    out["wall_s"] = time.time() - t0
    log(f"[multi] phase 19: {out['wall_s']:.1f} s ({rec['card']})")


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _md_handover(torch, model, ref, rank, moved):
    """Forward hooks on ``model``'s activation quantizers that take this
    rank's rows of the one-process step's output (``ref``, by name) where
    the two differ by more than half a quant step, after checking that
    they differ by at most one (deviation 14: the other batch size sums the
    convolutions in another order); ``moved`` counts [taken, elements]."""
    def take(n, mod, out):
        r = ref[n].to(out.device).chunk(MD_GLOO_RANKS)[rank]
        d = r - out.detach()
        q = float(mod.scale.detach().abs().max())
        slack = 1e-5 * q + 2 * F32_EPS * float(out.detach().abs().max())
        if float(d.abs().max()) > q + slack:
            raise AssertionError(f"{n}: the ranks' and the one-process activations differ "
                                 f"by {float(d.abs().max())}, more than a quant step {q}")
        far = d.abs() > 0.5 * q
        moved[0] += int(far.sum())
        moved[1] += out.numel()
        return out + torch.where(far, d, torch.zeros_like(d))

    return [m.register_forward_hook(lambda mod, i, o, n=n: take(n, mod, o))
            for n, m in _act_quantizers(model)]


def _md_gloo(torch, rec):
    """Two gloo ranks on the one card (this script with ``--gloo-rank``):
    the resnet DP step against the one-process step on the full batch (its
    activation quantizers' outputs handed over as deviation 14's), and the
    d1024 LM's TP forward against the unsharded one."""
    import tempfile

    from jaxlsq_torch.parallel import make_train_step

    out_dir = tempfile.mkdtemp(prefix="md_gloo_", dir=os.environ.get("TMPDIR"))
    # the one-process reference: one step on the full batch, its activation
    # quantizers' outputs saved for the ranks
    batch = _image_batches(torch, 1, MD_GLOO_B, seed=195)
    model = _resnet(torch, "cuda", seed=0)
    acts = {}
    hooks = [m.register_forward_hook(
        lambda mod, i, o, n=n: acts.__setitem__(n, o.detach().cpu()))
        for n, m in _act_quantizers(model)]
    step = make_train_step(model, _sgd(torch, model), jit=False)
    loss = float(step(batch[0])["loss"])
    for h in hooks:
        h.remove()
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(acts, os.path.join(out_dir, "ref_acts.pt"))
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gloo-rank",
                               str(r), "--gloo-port", port, "--gloo-out", out_dir], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(MD_GLOO_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"[multi] gloo rank {r} exited {p.returncode}:\n"
                                 + logs[r][-4000:])
    got = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
           for r in range(MD_GLOO_RANKS)]
    res = {"ranks": MD_GLOO_RANKS, "batch": MD_GLOO_B}

    def worst_leaf(st):
        worst = 0.0
        for k, want in state.items():
            if not want.is_floating_point():
                if not torch.equal(st[k], want):
                    raise AssertionError(f"[multi] gloo DP: {k} differs")
                continue
            w = want.double()
            worst = max(worst, float((st[k].double() - w).abs().max())
                        / max(float(w.abs().max()), 1.0))
        return worst

    # every rank's state and loss against the one-process step's
    worst = max(worst_leaf(g["state"]) for g in got)
    free = max(worst_leaf(g["free_state"]) for g in got)
    dloss = max(abs(g["loss"] - loss) for g in got) / abs(loss)
    free_loss = max(abs(g["free_loss"] - loss) for g in got) / abs(loss)
    moved = [sum(g["moved"][0] for g in got), sum(g["moved"][1] for g in got)]
    res["dp"] = {"worst_leaf_rel": worst, "loss_rel": dloss, "moved": moved,
                 "without_hand_over": {"worst_leaf_rel": free, "loss_rel": free_loss},
                 "collectives": got[0]["dp_collectives"]}
    log(f"[multi] gloo, {MD_GLOO_RANKS} ranks on the one card (CUDA tensors): the "
        f"resnet18_cifar DP step (B={MD_GLOO_B} over the ranks) within {worst:.3g} of each "
        f"leaf's largest magnitude and {dloss:.3g} of the loss of the one-process step on "
        f"the full batch, {moved[0]} of {moved[1]} activation elements one quant step apart "
        f"taken from it; without that hand-over {free:.3g} and {free_loss:.3g}; collectives "
        f"a rank {got[0]['dp_collectives']}")
    if worst > 2e-5 or dloss > 1e-5 or moved[0] > MAX_MOVED_SHARE * moved[1]:
        raise AssertionError(f"[multi] gloo DP step: {res['dp']} (limits 2e-5 of a leaf, "
                             f"1e-5 of the loss, {MAX_MOVED_SHARE:g} of the elements moved)")
    tp = [g["tp"] for g in got]
    res["tp"] = tp
    if any(t["max_abs_err"] > 1e-5 or not t["tokens_equal"] for t in tp):
        raise AssertionError(f"[multi] gloo TP: {tp}")
    log(f"[multi] gloo TP of the d1024 x {DEPTH} LM over 'model' = 2: every rank's logits "
        f"within {max(t['max_abs_err'] for t in tp):.3g} of the unsharded model's, greedy "
        f"tokens equal; collectives a forward {tp[0]['collectives']}")
    return res


def gloo_rank(torch, rank, port, out_dir):
    """One of ``_md_gloo``'s ranks."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(rank),
                      WORLD_SIZE=str(MD_GLOO_RANKS), LOCAL_RANK="0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    import torch.distributed as dist

    from jaxlsq_torch import _build
    from jaxlsq_torch.parallel import (initialize_distributed, make_mesh, make_train_step,
                                       shard_batch)
    from jaxlsq_torch.serve import shard_converted

    _build.load_library()
    initialize_distributed(device="cpu")
    out = {}
    mesh = make_mesh()
    batch = _image_batches(torch, 1, MD_GLOO_B, seed=195)[0]
    local = {k: v.to("cuda") for k, v in shard_batch(batch, mesh).items()}
    ref = torch.load(os.path.join(out_dir, "ref_acts.pt"))
    for hand_over in (False, True):
        model = _resnet(torch, "cuda", seed=0)
        moved = [0, 0]
        hooks = _md_handover(torch, model, ref, rank, moved) if hand_over else []
        step = make_train_step(model, _sgd(torch, model), jit=False, mesh=mesh)
        _md_counts()
        loss = float(step(local)["loss"])
        counts = _md_counts()
        for h in hooks:
            h.remove()
        st = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        if hand_over:
            out.update(loss=loss, state=st, moved=moved, dp_collectives=counts)
        else:
            out.update(free_loss=loss, free_state=st)
    tmesh = make_mesh(model=MD_GLOO_RANKS)
    model, _, _ = _lm(torch, 8, T0 + 16, seed=0)
    g = torch.Generator(device="cuda").manual_seed(196)
    prompt = torch.randint(0, VOCAB, (2, T0), device="cuda", generator=g)
    want = model(prompt)
    want_t = _greedy(torch, model, prompt)
    shard_converted(model, tmesh)
    _md_counts()
    got = model(prompt)
    counts = _md_counts()
    out["tp"] = {"max_abs_err": float((got - want).abs().max()),
                 "tokens_equal": bool(torch.equal(_greedy(torch, model, prompt), want_t)),
                 "collectives": counts}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 20: the pipeline (jaxlsq/parallel/pipeline.py) and lab.parallel_qat
# ---------------------------------------------------------------------------

# phase 3's LM in QAT mode at phase 16's target's width (16 heads, rope), B =
# 16 sequences of 256 tokens a step in 4 microbatches; a window of MB + 1
# microbatches closes in the second step
PP_B, PP_T, PP_MB, PP_STEPS, PP_TIMED, PP_SEED = 16, 256, 4, 3, 5, 20
PP_WINDOW, PP_RANKS = PP_MB + 1, 4
PP_MESHES = {"1x4": ("window", 1, 4, "ref_window.pt"), "2x2": ("pinned", 2, 2, "ref_pinned.pt")}


def _pp_qc(kind):
    """'learning' (no window), 'window' (it closes in the second step) or
    'pinned' (learnable activation quantizers whose gradient scale counts
    the global microbatch, jaxlsq's tests/test_pipeline.py:168-202)."""
    from jaxlsq_torch.models import default_qconfig

    qc = default_qconfig(8, 8, per_channel_weights=True,
                         init_batches=PP_WINDOW if kind == "window" else 0)
    if kind == "pinned":
        qc = dataclasses.replace(qc, activation=dataclasses.replace(
            qc.activation, init_mode="learnable", n_batches=-1,
            numel=(PP_B // PP_MB) * PP_T * DIM))
    return qc


def _pp_lm(torch, kind):
    from jaxlsq_torch.models import QuantTransformerLM

    return QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, _pp_qc(kind), max_len=PP_T,
                              pos_embedding="rope", device="cuda", seed=PP_SEED)


def _pp_batches(torch):
    g = torch.Generator(device="cuda").manual_seed(201)
    return [torch.randint(0, VOCAB, (PP_B, PP_T), device="cuda", generator=g)
            for _ in range(PP_STEPS)]


def _pp_loss(logits, labels):
    import torch.nn.functional as F

    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           labels[:, 1:].reshape(-1))


def _pp_sgd(params):
    import torch

    return torch.optim.SGD(params, lr=1e-2, momentum=0.9)


def _pp_train(torch, mesh, kind, batches, *, jit=False, remat=False, accum=False,
              mb=PP_MB, timed=0, keep=None):
    """``batches`` through the pipeline over ``mesh`` (``accum``: through
    ``make_train_step(accum_steps=mb)``): losses, state, fake-quant launches
    and ms a call; then ``timed`` more calls on the last batch (a captured
    step: its graph's replay too); ``keep(model)`` before the first step.
    ``launches``: every kernel launch of the run."""
    from jaxlsq_torch.ops.fake_quant import LAUNCHES as FQ
    from jaxlsq_torch.parallel import (create_pipeline_state, make_pipeline_train_step,
                                       make_train_step)

    start = _pp_launches()
    model = _pp_lm(torch, kind)
    if accum:
        opt = _pp_sgd(model.parameters())
        step = make_train_step(model, opt, loss_fn=lambda lg, b: _pp_loss(lg, b["label"]),
                               jit=jit, accum_steps=mb)
    else:
        model, opt = create_pipeline_state(model, _pp_sgd, mesh)
        step = make_pipeline_train_step(model, opt, mesh, num_microbatches=mb,
                                        loss_fn=_pp_loss, jit=jit, remat=remat)
    if keep is not None:
        keep(model)
    losses, fq, ms = [], [], []
    for t in batches:
        before = dict(FQ)
        torch.cuda.synchronize()
        s = time.perf_counter()
        losses.append(step({"input": t, "label": t})["loss"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - s) * 1e3)
        fq.append({k: FQ[k] - before[k] for k in FQ if FQ[k] != before[k]})
    out = {"losses": torch.stack(losses),
           "state": {k: v.detach().clone() for k, v in model.state_dict().items()},
           "fq": fq, "call_ms": ms, "model": model, "step": step}
    if timed:
        batch = {"input": batches[-1], "label": batches[-1]}
        torch.cuda.synchronize()
        s = time.perf_counter()
        for _ in range(timed):
            step(batch)
        torch.cuda.synchronize()
        out["step_ms"] = (time.perf_counter() - s) * 1e3 / timed
        if jit:
            out["replay_ms"] = min(events_ms(_graph_of(step).replay)[0] for _ in range(timed))
    out["launches"] = _pp_added({}, start)
    return out


def _pp_launches():
    """Every kernel wrapper's launch count on phase 20's path."""
    from jaxlsq_torch.ops.fake_quant import LAUNCHES as FQ
    from jaxlsq_torch.serve.attention import LAUNCHES as ATTN
    from jaxlsq_torch.serve.matmul import LAUNCHES as MM

    return {**FQ, **MM, **ATTN}


def _pp_added(into, start):
    """``into`` with the launches since the counts ``start`` added."""
    for k, v in _pp_launches().items():
        into[k] = into.get(k, 0) + v - start.get(k, 0)
    return into


def _pp_diff(torch, want, got):
    """(unequal leaves, worst float leaf's error over its largest magnitude
    (at least 1)); integer and bool leaves must be equal."""
    bad, worst = [], 0.0
    for k, w in want.items():
        g = got[k].to(w.device)
        if torch.equal(w, g):
            continue
        bad.append(k)
        if not w.is_floating_point():
            raise AssertionError(f"[pipeline] {k}: integer leaf differs")
        w64 = w.double()
        worst = max(worst, float((g.double() - w64).abs().max())
                    / max(1.0, float(w64.abs().max())))
    return bad, worst


def _pp_cpu(torch, state):
    return {k: v.detach().cpu() for k, v in state.items()}


def _pp_leg_a(torch, rec, mesh, out, out_dir):
    """World size 1 on NCCL, a (1, 1) mesh: the pipeline against
    make_train_step(accum_steps=4); captured and remat = eager; the window's
    deferral; the references of leg (b)."""
    batches = _pp_batches(torch)
    res = {}
    acc = _pp_train(torch, None, "learning", batches, accum=True, timed=PP_TIMED)
    eager = _pp_train(torch, mesh, "learning", batches, timed=PP_TIMED)
    bad, worst = _pp_diff(torch, acc["state"], eager["state"])
    loss_rel = float(((eager["losses"] - acc["losses"]).abs() / acc["losses"].abs()).max())
    res["vs_accum"] = {"bit_equal": not bad and torch.equal(acc["losses"], eager["losses"]),
                       "unequal_leaves": len(bad), "worst_leaf_rel": worst,
                       "loss_rel": loss_rel, "leaves": len(acc["state"])}
    if worst > 2e-5 or loss_rel > 1e-5:
        raise AssertionError(f"[pipeline] (1, 1) against accum_steps=4: {res['vs_accum']}")
    cap = _pp_train(torch, mesh, "learning", batches, jit=True, timed=PP_TIMED)
    remat = _pp_train(torch, mesh, "learning", batches, remat=True)
    for what, other in (("captured", cap), ("remat", remat)):
        bad, _ = _pp_diff(torch, eager["state"], other["state"])
        if bad or not torch.equal(eager["losses"], other["losses"]):
            raise AssertionError(f"[pipeline] {what} != eager: {bad[:6]}, losses "
                                 f"{eager['losses'].tolist()} {other['losses'].tolist()}")
    res["ms"] = {"accum_eager_step": acc["step_ms"], "eager_step": eager["step_ms"],
                 "captured_call": cap["step_ms"], "captured_replay": cap["replay_ms"]}
    res["fq_launches"] = {"eager_step": eager["fq"][1], "captured_warmup": cap["fq"][0],
                          "captured_capture": cap["fq"][1], "captured_replay": cap["fq"][2]}
    for what, got, names in (("an eager step", eager["fq"][1], FQ_KERNELS),
                             ("a remat step", remat["fq"][1], FQ_KERNELS),
                             ("the capture", cap["fq"][1], TRACED_KERNELS)):
        if any(not got.get(k) for k in names):
            raise AssertionError(f"[pipeline] {what} launched {got}, not each of {names}")
    res["p2p"] = dict(_md_counts())

    # the window closes at the second step's second microbatch: the same
    # losses and observer state as the accumulation step, its later
    # microbatches' scale gradients deferred
    wacc = _pp_train(torch, None, "window", batches, accum=True)
    wpipe = _pp_train(torch, mesh, "window", batches)
    wcap = _pp_train(torch, mesh, "window", batches, jit=True)
    bad, _ = _pp_diff(torch, wpipe["state"], wcap["state"])
    if bad or not torch.equal(wpipe["losses"], wcap["losses"]):
        raise AssertionError(f"[pipeline] window: captured != eager: {bad[:6]}")
    obs = [k for k in wacc["state"] if ".act_fq." in k
           and k.rsplit(".", 1)[1] in ("obs_min", "obs_max", "obs_seen", "current_batch")]
    obs_bad = [k for k in obs if not torch.equal(wacc["state"][k], wpipe["state"][k])]
    moved = [k for k in wacc["state"] if k.endswith("act_fq.scale")
             and not torch.equal(wacc["state"][k], wpipe["state"][k])]
    _, deferred = _pp_diff(torch, wacc["state"], wpipe["state"])
    res["window"] = {"losses_equal_through_step_2": torch.equal(wacc["losses"][:2],
                                                                wpipe["losses"][:2]),
                     "observer_leaves_equal": len(obs) - len(obs_bad),
                     "act_scales_deferred": len(moved), "worst_leaf_rel_vs_accum": deferred}
    if not res["window"]["losses_equal_through_step_2"] or obs_bad or not moved:
        raise AssertionError(f"[pipeline] window: {res['window']}, {obs_bad[:4]}")

    # leg (b)'s references: the (1, 1) window pipeline, and the (1, 1)
    # pipeline over 8 microbatches of 2 rows (the (2, 2) mesh's microbatches)
    # with every activation quantizer's output kept for deviation 14's
    # hand-over
    acts, calls = {}, {}

    def record(n):
        def hook(mod, i, o):  # the k-th call is step k // (2 MB)'s
            k = calls.get(n, 0)
            calls[n] = k + 1
            acts.setdefault((k // (2 * PP_MB), n), []).append(o.detach().cpu())
        return hook

    def keep(model):
        for n, m in _act_quantizers(model):
            m.register_forward_hook(record(n))

    pinned = _pp_train(torch, mesh, "pinned", batches, mb=2 * PP_MB, keep=keep)
    for r in (eager, cap, remat, wpipe, wcap, pinned):
        for k, v in r["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    for r in (acc, wacc):
        for k, v in r["launches"].items():
            out["reference_launches"][k] = out["reference_launches"].get(k, 0) + v
    torch.save(_pp_cpu(torch, wpipe["state"]), os.path.join(out_dir, "ref_window.pt"))
    torch.save(_pp_cpu(torch, pinned["state"]), os.path.join(out_dir, "ref_pinned.pt"))
    torch.save({k: torch.cat(v) for k, v in acts.items()},
               os.path.join(out_dir, "ref_acts.pt"))
    res["losses"] = {"window": wpipe["losses"].tolist(), "pinned": pinned["losses"].tolist()}
    out["a"] = res
    log(f"[pipeline] (a) (data 1, stage 1) on NCCL, d{DIM} x {DEPTH} LM at B={PP_B}, "
        f"t={PP_T}, MB={PP_MB}, {PP_STEPS} steps in learning mode against "
        f"make_train_step(accum_steps={PP_MB}): "
        + ("every one of {} leaves and the losses bit-equal".format(res["vs_accum"]["leaves"])
           if res["vs_accum"]["bit_equal"] else
           f"within {worst:.3g} of each leaf's largest magnitude and {loss_rel:.3g} of the "
           f"loss ({res['vs_accum']['unequal_leaves']} leaves not bit-equal)")
        + "; captured and remat bit-equal to eager; the window closing in step 2 (captured "
        "= eager bit for bit): losses "
        f"and {res['window']['observer_leaves_equal']} observer leaves equal to the "
        f"accumulation step's, {len(moved)} activation scales deferred (worst leaf "
        f"{deferred:.3g} from it); ms a step: eager {res['ms']['eager_step']:.2f} "
        f"(accum_steps {res['ms']['accum_eager_step']:.2f}), captured call "
        f"{res['ms']['captured_call']:.2f}, replay {res['ms']['captured_replay']:.2f} "
        f"({rec['card']}); fake-quant launches an eager step {res['fq_launches']['eager_step']}, "
        f"at the capture {res['fq_launches']['captured_capture']}, a replay "
        f"{res['fq_launches']['captured_replay']}; bubble share (S - 1)/(MB + S - 1) = 0")
    return eager


def _pp_leg_b(torch, rec, out, out_dir):
    """PP_RANKS gloo ranks of this script on the one card: (1, 4) and (2, 2)
    against leg (a)'s one-process references."""
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gloo-rank",
                               str(r), "--gloo-port", port, "--gloo-out", out_dir,
                               "--gloo-leg", "pipeline"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(PP_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"[pipeline] gloo rank {r} exited {p.returncode}:\n"
                                 + logs[r][-4000:])
    got = [torch.load(os.path.join(out_dir, f"pp_rank{r}.pt"), weights_only=False)
           for r in range(PP_RANKS)]
    want_losses = out["a"]["losses"]
    res = {}
    for name, (kind, data, stages, _) in PP_MESHES.items():
        legs = [g[name] for g in got]
        worst = max(g["worst_leaf_rel"] for g in legs)
        loss_rel = max(abs(a - b) / abs(b) for g in legs
                       for a, b in zip(g["losses"], want_losses[kind]))
        sends = sum(g["p2p"][-1][0] for g in legs) // data
        recvs = sum(g["p2p"][-1][1] for g in legs) // data
        moved = [sum(g["moved"][0] for g in legs), sum(g["moved"][1] for g in legs)]
        leg = {"worst_leaf_rel": worst, "loss_rel": loss_rel, "moved": moved,
               "sends_a_step": sends, "recvs_a_step": recvs,
               "want_p2p": 2 * (stages - 1) * PP_MB, "step_ms": [g["step_ms"] for g in legs],
               "bytes": [g["bytes"] for g in legs], "block_bytes": [g["block_bytes"] for g in legs],
               "bit_equal_ranks": sum(1 for g in legs if g["worst_leaf_rel"] == 0.0),
               "bubble_share": (stages - 1) / (PP_MB + stages - 1)}
        res[name] = leg
        full = got[0]["full_block_bytes"]
        log(f"[pipeline] (b) {PP_RANKS} gloo ranks on the one card, (data {data}, stage "
            f"{stages}), {PP_STEPS} steps ({kind}): every rank's leaves within {worst:.3g} of "
            f"each leaf's largest magnitude and the loss within {loss_rel:.3g} of leg (a)'s "
            f"one-process pipeline ({leg['bit_equal_ranks']} of {PP_RANKS} ranks bit-equal); "
            + (f"{moved[0]} of {moved[1]} activation elements handed over (deviation 14); "
               if kind == "pinned" else "")
            + f"sends / receives a step and data replica {sends} / {recvs} (2(S-1)MB = "
            f"{leg['want_p2p']}); ms a step by rank {[round(x, 1) for x in leg['step_ms']]} "
            f"(one card shared by {PP_RANKS} processes, gloo through host memory: not a "
            f"scaling figure; {rec['card']}); parameter bytes by rank {leg['bytes']}, the "
            f"blocks' {leg['block_bytes']} of {full} ({1 / stages:.2f}); bubble share "
            f"{leg['bubble_share']:.3f}")
        if (worst > 2e-5 or loss_rel > 1e-5 or sends != leg["want_p2p"]
                or recvs != leg["want_p2p"] or moved[0] > MAX_MOVED_SHARE * max(moved[1], 1)):
            raise AssertionError(f"[pipeline] (b) {name}: {leg}")
    out["b"] = res


def pp_rank(torch, rank, port, out_dir):
    """One of ``_pp_leg_b``'s ranks."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(rank),
                      WORLD_SIZE=str(PP_RANKS), LOCAL_RANK="0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    import torch.distributed as dist

    from jaxlsq_torch import _build, _dist
    from jaxlsq_torch.parallel import (create_pipeline_state, initialize_distributed,
                                       make_pipeline_train_step, pipeline_mesh, shard_batch)

    _build.load_library()
    initialize_distributed(device="cpu")
    batches = _pp_batches(torch)
    acts = torch.load(os.path.join(out_dir, "ref_acts.pt"), mmap=True)
    out = {}
    for name, (kind, data, stages, ref_file) in PP_MESHES.items():
        mesh = pipeline_mesh(stage=stages, data=data)
        d = mesh.get_local_rank("data")
        model = _pp_lm(torch, kind)
        full_blocks = sum(p.numel() * p.element_size() for b in model.blocks()
                          for p in b.parameters())
        stage, opt = create_pipeline_state(model, _pp_sgd, mesh)
        del model
        moved, hooks, at = [0, 0], [], [0]
        if kind == "pinned":
            # deviation 14's hand-over: the one-process run's microbatch
            # 4 d + j is this replica's microbatch j (2 rows each)
            rows = PP_B // data // PP_MB
            calls = {}

            def take(n, mod, o):
                j = calls.get(n, 0)
                calls[n] = j + 1
                lo = d * (PP_B // data) + j * rows
                r = acts[(at[0], n)][lo:lo + rows].to(o.device)
                diff = r - o.detach()
                q = float(mod.scale.detach().abs().max())
                slack = 1e-5 * q + 2 * F32_EPS * float(o.detach().abs().max())
                if float(diff.abs().max()) > q + slack:
                    raise AssertionError(f"{n}: the rank's and the one-process activations "
                                         f"differ by {float(diff.abs().max())}, more than a "
                                         f"quant step {q}")
                far = diff.abs() > 0.5 * q
                moved[0] += int(far.sum())
                moved[1] += o.numel()
                return o + torch.where(far, diff, torch.zeros_like(diff))

            hooks = [m.register_forward_hook(lambda mod, i, o, n=n: take(n, mod, o))
                     for n, m in _act_quantizers(stage)]
        step = make_pipeline_train_step(stage, opt, mesh, num_microbatches=PP_MB,
                                        loss_fn=_pp_loss, jit=False)
        losses, p2p, ms = [], [], []
        for i, t in enumerate(batches):
            at[0] = i
            calls_before = _dist.COUNTS.copy()
            local = {k: v.to("cuda") for k, v in shard_batch({"input": t, "label": t},
                                                             mesh).items()}
            torch.cuda.synchronize()
            s = time.perf_counter()
            losses.append(float(step(local)["loss"]))
            ms.append((time.perf_counter() - s) * 1e3)
            if kind == "pinned":
                calls.clear()
            p2p.append((_dist.COUNTS["send"] - calls_before["send"],
                        _dist.COUNTS["recv"] - calls_before["recv"]))
        for h in hooks:
            h.remove()
        ref = torch.load(os.path.join(out_dir, ref_file), mmap=True)
        _, worst = _pp_diff(torch, {k: ref[k] for k in stage.state_dict()},
                            {k: v.detach().cpu() for k, v in stage.state_dict().items()})
        out[name] = {"losses": losses, "p2p": p2p, "step_ms": min(ms[1:]),
                     "worst_leaf_rel": worst, "moved": moved,
                     "bytes": sum(p.numel() * p.element_size() for p in stage.parameters()),
                     "block_bytes": sum(p.numel() * p.element_size() for b in stage.blocks()
                                        for p in b.parameters())}
        out["full_block_bytes"] = full_blocks
        del stage, opt, step
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(out_dir, f"pp_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _pp_leg_c(torch, rec, mesh, eager, out):
    """Gather leg (a)'s eager state into one plain LM; its eval logits
    against the stage module's; convert at w8 and w4 and generate."""
    from torch.profiler import ProfilerActivity, profile

    from jaxlsq_torch import interop
    from jaxlsq_torch.models import QuantTransformerLM, default_qconfig
    from jaxlsq_torch.parallel import gather_pipeline_model, make_eval_step
    from jaxlsq_torch.serve import convert, make_generate
    from jaxlsq_torch.serve.attention import LAUNCHES as ATTN
    from jaxlsq_torch.serve.matmul import LAUNCHES as MM

    stage = eager["model"]
    lm = gather_pipeline_model(stage, mesh)
    g = torch.Generator(device="cuda").manual_seed(202)
    toks = torch.randint(0, VOCAB, (2, PP_T), device="cuda", generator=g)
    want = make_eval_step(stage)({"input": toks})
    got = make_eval_step(lm)({"input": toks})
    err = float((got - want).abs().max())
    res = {"eval_max_abs_err": err, "eval_bit_equal": bool(torch.equal(got, want))}
    if err > 1e-5:
        raise AssertionError(f"[pipeline] (c) gathered LM's eval logits {err} from the stage's")
    tree = interop.qat_variables(lm)
    prompt = toks[:1, :16]
    for wbits in (8, 4):
        qc = default_qconfig(wbits, 8, per_channel_weights=True)
        served = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, qc.for_serving("none"),
                                    max_len=PP_T, pos_embedding="rope", device="cuda")
        interop.load_variables(served, convert(tree, qc))
        gen = make_generate(served, 16, 32)
        before = {**MM, **ATTN}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            toks_out = gen(prompt)
            torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in {**MM, **ATTN}.items() if v != before[k]}
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and ("wo_mma" in e.key or "decode_attention" in e.key)})
        res[f"w{wbits}"] = {"tokens": toks_out[0].tolist(), "launches": launches,
                            "kernels": names}
        key = f"wo{wbits}"
        if (toks_out.shape != (1, 32) or not launches.get(key)
                or not launches.get("decode_attention")
                or not any("wo_mma" in n for n in names)
                or not any("decode_attention_span" in n for n in names)):
            raise AssertionError(f"[pipeline] (c) w{wbits} generate: {res[f'w{wbits}']}")
    out["c"] = res
    log(f"[pipeline] (c) the gathered d{DIM} x {DEPTH} LM: eval logits "
        + ("bit-equal to" if res["eval_bit_equal"] else f"within {err:.3g} of")
        + " the stage module's; served at w8 and w4, B=1, 16 + 32 tokens: launches "
        f"{res['w8']['launches']} / {res['w4']['launches']}; profiled kernels "
        f"{res['w8']['kernels']} / {res['w4']['kernels']}")


def _pp_leg_d(torch, rec, out):
    """lab.parallel_qat at world size 1 (the NCCL group up), 10 steps."""
    from jaxlsq_torch.lab import parallel_qat

    t0 = time.time()
    got = parallel_qat.main(["--steps", "10"])
    ok = (tuple(got["ep"].shape) == (2, 8) and tuple(got["pp"].shape) == (2, parallel_qat.T,
                                                                          parallel_qat.VOCAB)
          and bool(torch.isfinite(got["pp"]).all()))
    out["d"] = {"s": time.time() - t0, "ep_tokens": got["ep"][0].tolist()}
    if not ok:
        raise AssertionError(f"[pipeline] (d) lab.parallel_qat: {got}")
    log(f"[pipeline] (d) lab.parallel_qat, 10 steps EP and PP at world size 1: "
        f"{out['d']['s']:.1f} s")


def phase_pipeline(torch, rec):
    """Phase 20: the pipeline at world size 1 on NCCL (legs a, c, d) and over
    PP_RANKS gloo ranks on the one card (leg b)."""
    import tempfile

    from jaxlsq_torch.parallel import initialize_distributed, pipeline_mesh

    import shutil

    t0 = time.time()
    # launches of the pipeline's own runs (leg (a)'s pipeline steps, leg
    # (c)'s gathered LM), of leg (a)'s accumulation-step references and of
    # the lab (its EP flow is no pipeline), apart
    out = {"launches": {}, "reference_launches": {}, "lab_launches": {}}
    rec["pipeline"] = out
    reset_counts()
    _md_counts()
    port = _free_port()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
                      WORLD_SIZE="1", LOCAL_RANK="0")
    rank, world = initialize_distributed()
    import torch.distributed as dist

    if (rank, world) != (0, 1) or dist.get_backend() != "nccl":
        raise AssertionError(f"[pipeline] bring-up gave rank {rank} of {world} on "
                             f"{dist.get_backend()}")
    out_dir = tempfile.mkdtemp(prefix="pp_", dir=os.environ.get("TMPDIR"))
    try:
        try:
            mesh = pipeline_mesh(stage=1)
            eager = _pp_leg_a(torch, rec, mesh, out, out_dir)
            start = _pp_launches()
            _pp_leg_c(torch, rec, mesh, eager, out)
            _pp_added(out["launches"], start)
            del eager
            start = _pp_launches()
            _pp_leg_d(torch, rec, out)
            _pp_added(out["lab_launches"], start)
        finally:
            dist.destroy_process_group()
            for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
                os.environ.pop(k, None)
        total = _pp_launches()
        for k, v in total.items():
            parts = sum(out[c].get(k, 0) for c in ("launches", "reference_launches",
                                                   "lab_launches"))
            if parts != v:
                raise AssertionError(f"[pipeline] {k}: {v} launches, {parts} accounted for")
        for k in FQ_KERNELS + TRACED_KERNELS + ("wo8", "wo4", "decode_attention"):
            if not out["launches"].get(k):
                raise AssertionError(f"kernel {k} was never launched on the pipeline's path")
        out["one_process_s"] = time.time() - t0
        torch.cuda.empty_cache()
        _pp_leg_b(torch, rec, out, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    out["wall_s"] = time.time() - t0

    def shown(c):
        return {k: v for k, v in out[c].items() if v}
    log(f"[pipeline] phase 20: {out['wall_s']:.1f} s ({rec['card']}); launches of the "
        f"pipeline's own runs {shown('launches')}; of the accumulation-step references "
        f"{shown('reference_launches')}; of lab.parallel_qat {shown('lab_launches')}")


def _greedy(torch, model, prompt, n=8):
    from jaxlsq_torch.serve import make_generate

    return make_generate(model, prompt.shape[1], n)(prompt)


def main(argv):
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", help="also write the full record here (JSON)")
    parser.add_argument("--gloo-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--gloo-port", help=argparse.SUPPRESS)
    parser.add_argument("--gloo-out", help=argparse.SUPPRESS)
    parser.add_argument("--gloo-leg", default="multi_device", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    record = args.record

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2

    if args.gloo_rank is not None:  # one of phase 19's or phase 20's gloo ranks
        rank_fn = pp_rank if args.gloo_leg == "pipeline" else gloo_rank
        rank_fn(torch, args.gloo_rank, args.gloo_port, args.gloo_out)
        return 0

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
    phase_convnet(torch, rec)
    phase_observers(torch, rec)
    phase_third_party(torch, rec)
    phase_decode_features(torch, rec)
    phase_int8_moe(torch, rec)
    phase_tooling(torch, rec)
    phase_multi_device(torch, rec)
    phase_pipeline(torch, rec)
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
