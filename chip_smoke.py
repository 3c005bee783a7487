#!/usr/bin/env python3
"""Smoke test of the jaxlsq_torch serving port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--record PATH]

Runs from the root of a checkout, needs one CUDA card, imports no jax, and
exits non-zero on any failure (no phase is caught and skipped):

1. prints the card (``nvidia-smi`` name and power limit) and turns TF32 off;
2. builds the CUDA kernels from ``jaxlsq_torch/csrc`` and holds each against
   its plain PyTorch version at the main path's shapes (``wo8``/``wo4`` at
   M in {1, 8, 256} over every K x N of the d1024 LM plus an odd K;
   ``decode_attention`` for every cache carrier, a scalar index at B = 1
   and a per-slot index at B = 8, t in {1, 32}, L in {240, 2048}, and two
   windows);
3. drives the main path with the launch counts reset: the d1024 x 4 LM of
   the JAX package's decode benchmark (vocab 8192, 16 heads, max_len 240,
   int8 per-channel weights, bf16 cache, seeded random weights) through
   ``make_generate`` at B = 1 and 8 (tokens/s from the 16 -> 208 token
   slope), ``DecodeEngine`` (8 requests, each checked token for token
   against ``make_generate`` at B = 1), the int4-weight LM at B = 1, and the
   max_len 2048, B = 8 leg with int8 and int4 caches; checks the kernel
   path's logits against the plain path on the CPU; fails if a kernel of
   the path was never launched;
   profiles one B = 1 generate for the device's busy share and the time by
   kernel;
4. times each kernel at the main path's shapes (L2 flushed by rotating
   buffer copies): device time from the profiler's CUDA trace and time a
   call from CUDA events, beside its bound, its plain version and one
   PyTorch library call.

Prints one ``{"kernels": [...]}`` JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  ``--record PATH`` also writes the full
record (every check, time and profile) to PATH as JSON.
"""

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
ROOT = os.path.dirname(os.path.abspath(__file__))
VOCAB, DIM, DEPTH, HEADS, T0 = 8192, 1024, 4, 16, 32
N1, N2 = 16, 208
WO_SHAPES = {"qkv": (1024, 3072), "proj": (1024, 1024), "mlp_up": (1024, 4096),
             "mlp_down": (4096, 1024), "lm_head": (1024, 8192)}


def log(*a):
    print(*a, flush=True)


def bound(nbytes, flops):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def measure(torch, fn, arg_sets, reps=40):
    """(device ms, call ms) per call, cycling through ``arg_sets`` (copies of
    the inputs, so the working set exceeds the 50 MB L2).  Device ms: the
    summed durations of the kernels the calls ran, from the profiler's CUDA
    trace.  Call ms: CUDA events around back-to-back calls, which include
    the host's time to issue each call whenever the host is the slower."""
    from torch.profiler import ProfilerActivity, profile

    for a in arg_sets[:3]:
        fn(*a)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    e1.record()
    torch.cuda.synchronize()
    call_ms = e0.elapsed_time(e1) / reps
    for _ in range(3):  # a profile that recorded no kernel is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        # only device activity is recorded, so every row is device time
        dev_us = sum(e.self_device_time_total for e in prof.key_averages())
        if dev_us > 0:
            break
    else:
        raise AssertionError("the profiler saw no device time")
    return dev_us / 1e3 / reps, call_ms


def copies_for(nbytes, floor=160e6):
    return max(1, min(64, math.ceil(floor / max(nbytes, 1))))


def phase_kernels(torch, rec):
    from jaxlsq_torch import _build
    from jaxlsq_torch.core.spec import QuantSpec
    from jaxlsq_torch.serve.attention import decode_attention, decode_attention_plain
    from jaxlsq_torch.serve.matmul import wo_matmul, wo_matmul_plain
    from jaxlsq_torch.serve.pack import quantize_weight

    t0 = time.time()
    _build.load_library()
    rec["build_s"] = time.time() - t0
    log(f"[build] kernels built and loaded in {rec['build_s']:.1f} s")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    errs = {"wo8": 0.0, "wo4": 0.0, "decode_attention": 0.0}
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
    rec["max_abs_err"] = errs


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


def _lm(torch, wbits, max_len, seed):
    from jaxlsq_torch import interop
    from jaxlsq_torch.models import QuantTransformerLM, default_qconfig, init_variables

    qc = default_qconfig(wbits, 8, per_channel_weights=True).for_serving("none")
    model = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, qc, max_len=max_len,
                               device="cuda")
    variables = init_variables(model, seed=seed)
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
    for counts in (MM, ATTN):
        for k in counts:
            counts[k] = 0
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
    log(f"[main] make_generate int4 weights, bf16 cache, B=1: {tps:.1f} tokens/s")
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
        log(f"[main] max_len 2048, B=8, {name} cache: {tps:.1f} tokens/s "
            "(slope 16->80)")
    del longm
    torch.cuda.synchronize()
    main["wall_s"] = time.time() - t_main
    rec["launches"] = {**MM, **ATTN}
    log(f"[main] kernel launches on the main path: {rec['launches']}")
    for k, v in rec["launches"].items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was never launched on the main path")


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
            by_name[e.key[:60]] = e.self_device_time_total / 1e3
            n_kernels += e.count
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall * 1e3, "device_ms": dev_ms,
            "busy_share": dev_ms / (wall * 1e3), "kernels_per_token": n_kernels / N2,
            "top": top[:12]}


def _to_cpu(torch, tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(torch, v) for k, v in tree.items()}
    return tree.cpu()


def phase_times(torch, rec):
    import torch.nn.functional as F

    from jaxlsq_torch.core.spec import QuantSpec
    from jaxlsq_torch.serve.attention import decode_attention, decode_attention_plain
    from jaxlsq_torch.serve.matmul import LAUNCHES as MM
    from jaxlsq_torch.serve.matmul import wo_matmul, wo_matmul_plain
    from jaxlsq_torch.serve.pack import dequantize_weight, quantize_weight

    saved = dict(MM)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    times = {}
    rec["times"] = times
    for bits, name in ((8, "wo8"), (4, "wo4")):
        spec = QuantSpec.weight_default(bits, per_channel=True, axis=1)
        rows = []
        for layer, (k, n) in WO_SHAPES.items():
            w = torch.randn(k, n, device=dev, generator=g) * k ** -0.5
            p = quantize_weight(w, w.abs().amax(0) / spec.quant_max,
                                torch.zeros(n, device=dev), spec, bits=bits)
            wbytes = p.data.numel() + 8 * n
            reps = copies_for(wbytes)
            packs = [p] + [type(p)(p.data.clone(), p.scale.clone(), p.zero_point.clone(),
                                   bits=p.bits, axis=p.axis, k_axis=p.k_axis,
                                   orig_shape=p.orig_shape) for _ in range(reps - 1)]
            wdq = [dequantize_weight(q) for q in packs[:copies_for(4 * k * n)]]
            for m in (1, 8, 256):
                x = torch.randn(m, k, device=dev, generator=g)
                ms, call = measure(torch, wo_matmul, [(x, q) for q in packs])
                plain, _ = measure(torch, wo_matmul_plain, [(x, q) for q in packs], reps=20)
                lib, _ = measure(torch, torch.matmul, [(x, wd) for wd in wdq])
                b_ms, b_by = bound(4 * m * k + wbytes + 4 * m * n, 2 * m * k * n)
                rows.append({"layer": layer, "M": m, "K": k, "N": n, "ms": ms,
                             "call_ms": call, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                             "bound_by": b_by, "bytes": 4 * m * k + wbytes + 4 * m * n,
                             "flops": 2 * m * k * n})
                log(f"[time] {name} {layer} M={m} K={k} N={n}: {ms * 1e3:.2f} us on "
                    f"the device, {call * 1e3:.2f} us a call (bound {b_ms * 1e3:.2f} us by {b_by}; plain {plain * 1e3:.2f} us; "
                    f"torch.matmul on the dequantized f32 weight {lib * 1e3:.2f} us)")
        times[name] = rows

    hd = 64
    rows = []
    for carrier, b, length, t in (("int8", 8, 2048, 1), ("int4", 8, 2048, 1),
                                  ("bf16", 8, 2048, 1), ("bf16", 1, 240, 1),
                                  ("bf16", 8, 240, 1), ("bf16", 8, 240, 32)):
        q = torch.randn(b, HEADS, t, hd, device=dev, generator=g)
        one = _rand_cache(torch, carrier, b, HEADS, length, hd, g)
        nbytes_cache = sum(x.numel() * x.element_size() for x in
                           (one if isinstance(one, tuple) else (one,)))
        reps = copies_for(2 * nbytes_cache)
        caches = [(_rand_cache(torch, carrier, b, HEADS, length, hd, g),
                   _rand_cache(torch, carrier, b, HEADS, length, hd, g))
                  for _ in range(reps)]
        idx = torch.full((b,), length - t, dtype=torch.int32, device=dev)  # all keys live
        ms, call = measure(torch, lambda ck, cv: decode_attention(q, ck, cv, idx),
                           caches)
        plain, _ = measure(torch, lambda ck, cv: decode_attention_plain(q, ck, cv, idx),
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
        lib, _ = measure(torch, lambda k_, v_: F.scaled_dot_product_attention(
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
    MM.update(saved)


def kernels_line(rec):
    out = []
    for name, src, repl in (
            ("wo8", "jaxlsq_torch/csrc/wo_matmul.cu", "jaxlsq/serve/matmul.py:69"),
            ("wo4", "jaxlsq_torch/csrc/wo_matmul.cu", "jaxlsq/serve/matmul.py:93")):
        rows = [r for r in rec["times"][name] if r["M"] == 1]
        nbytes = sum(r["bytes"] for r in rows)
        flops = sum(r["flops"] for r in rows)
        b_ms, b_by = bound(nbytes, flops)
        out.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                    "launches": rec["launches"][name],
                    "max_abs_err": rec["max_abs_err"][name],
                    "ms": sum(r["ms"] for r in rows),
                    "plain_ms": sum(r["plain_ms"] for r in rows),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": sum(r["library_ms"] for r in rows),
                    "shape": "M=1, sum over qkv/proj/mlp_up/mlp_down/lm_head of "
                             "the d1024 LM (one of each per B=1 decode step)"})
    r = rec["times"]["decode_attention"][0]
    out.append({"name": "decode_attention", "route": "cuda",
                "source": "jaxlsq_torch/csrc/decode_attention.cu",
                "replaces": "jaxlsq/serve/attention.py:63",
                "launches": rec["launches"]["decode_attention"],
                "max_abs_err": rec["max_abs_err"]["decode_attention"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "shape": "int8 cache, B=8, H=KVH=16, hd=64, L=2048, t=1, all keys live"})
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
    sys.path.insert(0, ROOT)
    import jaxlsq_torch  # noqa: F401  (fails outside a checkout)

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
    phase_main(torch, rec)
    phase_times(torch, rec)
    rec["wall_s"] = time.time() - t0
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
