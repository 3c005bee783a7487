#!/usr/bin/env python3
"""Time the weight-only matmul kernels (``wo8``, ``wo4``, ``wo4g``), or with
``--lab`` the int4 lab's two kernels (``wo4_bf16``, ``wo4_native``), or with
``--fq`` the fake-quant kernels (forward, backward and fused, per tensor
and per channel), or with ``--int8`` the int8 x int8 kernels, of two
checkouts of this repo on one card, in turns (first, second, second,
first), so that two versions are compared within one run on one card:

    python3 wo_compare.py FIRST_DIR SECOND_DIR [--lab | --fq | --decode | --int8] [--out PATH]

Each turn is a process of its own that imports the checkout's
``jaxlsq_torch`` (building its kernels) and times them with this file's
checkout's ``chip_smoke._time_wo`` (device time from CUDA events, the
weights rotated past the L2; seeded weights, the same in every turn): the
five d1024 layer shapes at M = 1, 8 and 256, and K = N = 8192 at M = 1.
Prints one summary line a turn (µs: the M = 1 and M = 8 sums over the five
shapes, each shape at M = 256, K = N = 8192) and writes every row to
``--out`` as JSON.  ``--lab``: each checkout's ``lab.int4_kernel_lab``
kernels on the lab's seeded weights (``lab_weights``, rotated past the L2)
at M = 1, 16 and 128, K = N = 8192, timed by this checkout's
``chip_smoke.measure``; one summary line a turn (µs by kernel and M).
``--fq``: each checkout's ``ops.fake_quant`` in train mode, inputs rotated
past the L2.  The per-tensor backward: ``fq_bwd_pt`` and
``fq_bwd_pt_traced`` on unit-normal activations (the activation spec, ``s
= 6 / 127``) at (64, 64, 32, 32) (there also the per-tensor forward
``fq_fwd_pt`` and ``fq_fwd_pt_traced``), and summed over the 21 activation
quantizers' inputs of ``resnet18_cifar`` at B = 64 and the 9 of the d512 LM
at 8192 tokens (this checkout's models, run once on the CPU at a small
batch, the batch dimensions then set to the real ones); ``fq_fwdbwd_pt`` on
phase 11's per-tensor chain inputs (65536 x 1024).  The per-channel
backward on seeded lecun-normal weights (the resnet weight spec, ``s = 4
sd / 127``): ``fq_bwd_pc`` and ``fq_bwd_pc_traced``, and the forward
``fq_fwd_pc`` and ``fq_fwd_pc_traced``, at (512, 512, 3, 3) on
axis 0, at (512, 8192) on axis 1, and summed over the 21 per-channel
weights of ``resnet18_cifar`` and the 9 (K, N) weights of the d512 LM;
``fq_fwdbwd_pc`` on the (8192, 8192) chain inputs.  One summary line a
turn (µs).  ``--decode``: chip_smoke phase 3's B = 1 decode through each
checkout's serving path (the d1024 x 4 LM at int8 and at int4 weights,
seeded, a bf16 cache; ``_slope_tps``: tokens/s from the 16 -> 208 slope, the
least time of 3 rounds), which measures what each checkout's host dispatch
costs a token; in a checkout that has the serving operators
(``serve.custom_ops``), each turn also times the same decode with the layers
calling the ``torch.library`` operators in eager code, in turns with the
direct calls (direct, operators, operators, direct); one summary line a turn
(tokens/s).  ``--int8``: each checkout's ``act_quant_i8`` (I1, static),
``i8mm`` (I2: ``_i8mm`` on the int8 rows, static epilogue, the checkout's
own tiling) and the static int8 dense layer as the checkout serves it
(``static_int8_matmul``: I1 then I2, or one launch where the checkout
quantizes the rows inside I2) at the five d1024 layer shapes, M = 1, 8 and
256, on seeded per-channel packs (``chip_smoke._int8_pack``), weights and
activations rotated past the L2 (device µs, and µs a call back to back,
which is the host's issue time where the host is the slower); the MoE's
``static_int8_bmm`` (E = 8) at its two shapes and C = 1, 8 and 256; the w8a8
mobilenetv2_cifar served
'static_int8' at B = 128 (each distinct conv's ``static_int8_conv``, im2col
included, and the whole forward); and the B = 1 decode tokens/s of the d1024
LM in 'none', 'static_int8' and 'dynamic' in turn, twice, and where the
checkout fuses the quantization into I2 with the fusion on and off in turns
(on, off, off, on);
one summary line a turn (µs, the five shapes summed at each M; each bmm;
the convs summed over the net's layers, the depthwise ones alone, the
forward; tokens/s).
"""

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
KINDS = ("wo8", "wo4", "wo4g")
LAB_MS, LAB_K, LAB_N = (1, 16, 128), 8192, 8192


def lab_rows(torch, chip_smoke):
    """The checkout's int4 lab kernels: {kind: [{"M", "ms"}, ...]}."""
    import numpy as np

    from jaxlsq_torch.lab import int4_kernel_lab as lab
    from jaxlsq_torch.serve.pack import PackedWeight

    _, p4, w4, sc, r = lab.lab_weights(LAB_K, LAB_N, torch.device("cuda"))
    copies = chip_smoke.copies_for(LAB_K * LAB_N // 2)
    p4s = [p4] + [PackedWeight(p4.data.clone(), p4.scale, p4.zero_point, 4, 1, 0,
                               p4.orig_shape) for _ in range(copies - 1)]
    w4s = [w4] + [w4.clone() for _ in range(copies - 1)]
    rows = {"wo4_bf16": [], "wo4_native": []}
    for m in LAB_MS:
        x = torch.from_numpy(r.randn(m, LAB_K).astype(np.float32)).cuda()
        for kind, fn, args in (("wo4_bf16", lambda p: lab.run_bf16(x, p), [(p,) for p in p4s]),
                               ("wo4_native", lambda w: lab.run_native(x, w, sc),
                                [(w,) for w in w4s])):
            ms = min(chip_smoke.measure(fn, args, 20)[0] for _ in range(5))
            rows[kind].append({"M": m, "ms": ms})
    return rows


class _OperatorCalls:
    """While open, the checkout's serving layers reach ``wo_matmul`` and
    ``decode_attention`` through their ``torch.library`` operators
    (``serve.custom_ops``) in eager code too, as they do while a program is
    traced."""

    def __init__(self, torch):
        self.torch = torch
        self.layers = sys.modules["jaxlsq_torch.models.layers"]
        self.zoo = sys.modules["jaxlsq_torch.models.zoo"]
        from jaxlsq_torch.serve.attention import _qpos

        ops = torch.ops.jaxlsq_torch

        def wo(x, packed):
            k, n = packed.orig_shape
            return ops.wo_matmul(x, packed.data, packed.scale, packed.zero_point, packed.bits,
                                 packed.axis, packed.k_axis, k, n, packed.group_size or 0)

        def attention(q, ck, cv, cache_index, window=None):
            quantized = isinstance(ck, (tuple, list))
            kd, ks = (ck[0], ck[1]) if quantized else (ck, None)
            vd, vs = (cv[0], cv[1]) if quantized else (cv, None)
            return ops.decode_attention(q, kd, ks, vd, vs, _qpos(cache_index, q.shape[0],
                                                                  q.device), window or 0)

        self.calls = {(self.layers, "wo_matmul"): wo, (self.zoo, "decode_attention"): attention}

    def __enter__(self):
        self.saved = {key: getattr(*key) for key in self.calls}
        for (mod, name), fn in self.calls.items():
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)


def decode_rows(torch, chip_smoke):
    """Phase 3's B = 1 decode of the checkout: {"w8": row, "w4": row}, each
    the slope's tokens/s and its raw times; where the checkout has the
    serving operators (``serve.custom_ops``), also the same decode through
    them in eager code, in turns in this process (direct, operators,
    operators, direct)."""
    import contextlib
    import importlib.util

    import numpy as np

    ops = importlib.util.find_spec("jaxlsq_torch.serve.custom_ops") is not None
    r = np.random.RandomState(7)
    rows = {}
    for wbits, seed in ((8, 0), (4, 1)):
        model, _, _ = chip_smoke._lm(torch, wbits, chip_smoke.T0 + chip_smoke.N2, seed=seed)
        prompt = torch.as_tensor(r.randint(0, chip_smoke.VOCAB, size=(1, chip_smoke.T0)),
                                 device="cuda")
        tps, _, raw = chip_smoke._slope_tps(torch, model, 1, prompt, torch.bfloat16)
        rows[f"w{wbits}"] = {"tokens_per_s_b1": tps, **raw}
        if ops:
            turns = []
            for via_ops in (False, True, True, False):
                with _OperatorCalls(torch) if via_ops else contextlib.nullcontext():
                    turns.append((via_ops, chip_smoke._slope_tps(
                        torch, model, 1, prompt, torch.bfloat16)[0]))
            rows[f"w{wbits}"]["in_process"] = {
                "direct": [t for v, t in turns if not v], "operators": [t for v, t in turns if v]}
        del model
    return rows


def fq_weight_shapes():
    """This checkout's per-channel layer weights: {"resnet": [(shape, axis),
    ...], "lm": [...]}: ``resnet18_cifar``'s 21 and the d512 LM's 9 (K, N)
    ones on axis 1 (its embedding table, a lookup, has no ``kernel``)."""
    import torch

    import chip_smoke

    return {key: [(list(mod.kernel.shape), mod.weight_fq.cfg.spec.axis)
                  for mod in model.modules()
                  if getattr(mod, "weight_fq", None) is not None and hasattr(mod, "kernel")
                  and mod.weight_fq.cfg.spec.per_channel]
            for key, model in (("resnet", chip_smoke._resnet(torch, "cpu", 0)),
                               ("lm", chip_smoke._lm_qat(torch, "cpu", "xla")))}


def fq_act_shapes():
    """This checkout's activation quantizers' input shapes: {"resnet_act":
    [shape, ...], "lm_act": [...]}: ``resnet18_cifar``'s 21 at B = 64 and
    the d512 LM's 9 at B = 2, t = 4096, from one forward at a small batch
    (B = 2; B = 1, t = 8) with the batch dimensions then set."""
    import torch

    import chip_smoke

    out = {}
    for key, model, inp, lead in (
            ("resnet_act", chip_smoke._resnet(torch, "cpu", 0), torch.zeros(2, 3, 32, 32),
             (chip_smoke.TRAIN_B,)),
            ("lm_act", chip_smoke._lm_qat(torch, "cpu", "xla"),
             torch.zeros(1, 8, dtype=torch.long), chip_smoke.LM_LEGS[0])):
        shapes = []
        hooks = [m.register_forward_hook(lambda m, i, o: shapes.append(list(i[0].shape)))
                 for _, m in chip_smoke._act_quantizers(model)]
        with torch.no_grad():
            model(inp)
        for h in hooks:
            h.remove()
        out[key] = [list(lead) + shp[len(lead):] for shp in shapes]
    return out


def fq_rows(torch, chip_smoke, shapes):
    """The checkout's fake-quant kernels: {case: {kernel: ms}} (the sums'
    cases also list each shape's ms)."""
    from jaxlsq_torch.models import default_qconfig
    from jaxlsq_torch.ops.fake_quant import (fake_quant_backward,
                                             fake_quant_backward_traced,
                                             fake_quant_forward,
                                             fake_quant_forward_traced,
                                             fake_quant_fwdbwd)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    flags = torch.zeros(2, device=dev)  # train mode
    qc = default_qconfig(8, 8, per_channel_weights=True)

    def best(fns, args):
        return {k: min(chip_smoke.measure(fn, args)[0] for _ in range(3))
                for k, fn in fns.items()}

    def time_pair(shape, axis):
        spec = qc.weight_for_axis(axis).spec
        n, c = math.prod(shape), shape[axis]
        sd = (n // c) ** -0.5
        s, b = torch.full((c,), 4 * sd / spec.quant_max, device=dev), torch.zeros(c, device=dev)
        args = [(torch.randn(shape, device=dev, generator=g) * sd,
                 torch.randn(shape, device=dev, generator=g))
                for _ in range(chip_smoke.copies_for(12 * n))]
        return best({
            "fq_fwd_pc": lambda x, gg: fake_quant_forward(x, s, b, spec),
            "fq_fwd_pc_traced": lambda x, gg: fake_quant_forward_traced(x, s, b, flags, spec),
            "fq_bwd_pc": lambda x, gg: fake_quant_backward(gg, x, s, b, spec),
            "fq_bwd_pc_traced": lambda x, gg: fake_quant_backward_traced(gg, x, s, b, flags,
                                                                         spec)}, args)

    act = qc.activation.spec  # the table's per-tensor activation
    s_act = torch.full((1,), 6.0 / act.quant_max, device=dev)
    b_act = -s_act * (act.quant_max // 2)

    def time_pt(shape, fwd=False):
        n = math.prod(shape)
        args = [(torch.randn(shape, device=dev, generator=g),
                 torch.randn(shape, device=dev, generator=g))
                for _ in range(chip_smoke.copies_for(12 * n))]
        fns = {"fq_bwd_pt": lambda x, gg: fake_quant_backward(gg, x, s_act, b_act, act),
               "fq_bwd_pt_traced": lambda x, gg: fake_quant_backward_traced(
                   gg, x, s_act, b_act, flags, act)}
        if fwd:
            fns = {"fq_fwd_pt": lambda x, gg: fake_quant_forward(x, s_act, b_act, act),
                   "fq_fwd_pt_traced": lambda x, gg: fake_quant_forward_traced(
                       x, s_act, b_act, flags, act), **fns}
        return best(fns, args)

    rows = {"act_64x64x32x32": time_pt((64, 64, 32, 32), fwd=True)}
    for key in ("resnet_act", "lm_act"):
        per = [{"shape": shape, **time_pt(tuple(shape))} for shape in shapes[key]]
        rows[key] = {k: sum(r[k] for r in per) for k in ("fq_bwd_pt", "fq_bwd_pt_traced")}
        rows[key]["shapes"] = per
    rows["oihw_512x512x3x3"] = time_pair((512, 512, 3, 3), 0)
    rows["kn_512x8192"] = time_pair((512, 8192), 1)
    for key in ("resnet", "lm"):
        per = [{"shape": shape, "axis": axis, **time_pair(tuple(shape), axis)}
               for shape, axis in shapes[key]]
        rows[key] = {k: sum(r[k] for r in per) for k in (
            "fq_fwd_pc", "fq_fwd_pc_traced", "fq_bwd_pc", "fq_bwd_pc_traced")}
        rows[key]["shapes"] = per
    for kind, key in (("pc", "chain_8192x8192"), ("pt", "chain_65536x1024")):
        spec, shape = chip_smoke._chain_specs()[kind]
        x, gr, s0, b0 = chip_smoke._chain_inputs(torch, spec, shape, seed=21)
        rows[key] = {f"fq_fwdbwd_{kind}": min(chip_smoke.measure(
            lambda xx, gg: fake_quant_fwdbwd(gg, xx, s0, b0, spec=spec), [(x, gr)])[0]
            for _ in range(3))}
        del x, gr
    return rows


def int8_rows(torch, chip_smoke):
    """The checkout's int8 x int8 kernels: [{kind, layer, M, K, N, ms}]."""
    import dataclasses

    from jaxlsq_torch.serve.matmul import _i8mm, act_quant_i8, static_int8_matmul

    g = torch.Generator(device="cuda").manual_seed(23)
    sx = torch.tensor([0.03], device="cuda")
    z = torch.tensor([128], dtype=torch.int32, device="cuda")
    rows = []
    for layer, (k, n) in chip_smoke.WO_SHAPES.items():
        p = chip_smoke._int8_pack(torch, (k, n), g)
        packs = [p] + [dataclasses.replace(p, data=p.data.clone(), scale=p.scale.clone(),
                                           zero_point=p.zero_point.clone())
                       for _ in range(chip_smoke.copies_for(k * n + 8 * n) - 1)]
        for m in (1, 8, 256):
            x = torch.randn(m, k, device="cuda", generator=g)
            xs = [x] + [x.clone() for _ in range(chip_smoke.copies_for(4 * m * k) - 1)]
            xq, qx = act_quant_i8(x, sx, z, 0, 255)
            pairs = [(packs[i % len(packs)], xs[i % len(xs)])
                     for i in range(max(len(packs), len(xs)))]
            fns = {"act_quant_i8": (lambda a: act_quant_i8(a, sx, z, 0, 255),
                                    [(a,) for a in xs]),
                   "i8mm": (lambda q: _i8mm(xq[None], q.data[None], qx, q.scale, q.zero_point,
                                            "static", (0, 1), plain=False),
                            [(q,) for q in packs]),
                   "static_layer": (lambda q, a: static_int8_matmul(a, q, sx, z, 0, 255),
                                    pairs)}
            for kind, (fn, args) in fns.items():
                ts = [chip_smoke.measure(fn, args) for _ in range(2)]
                rows.append({"kind": kind, "layer": layer, "M": m, "K": k, "N": n,
                             "ms": min(t[0] for t in ts), "call_ms": min(t[1] for t in ts)})
    return rows


def int8_conv_rows(torch, chip_smoke):
    """The checkout's w8a8 mobilenetv2_cifar served 'static_int8' at B =
    MNV2_B (calibrated as phase 17 does): the forward's ms, and each
    distinct conv's ``static_int8_conv`` ms (the im2col's ops, I1 and I2)
    with the count of its layers: [{kind, ...}]."""
    from jaxlsq_torch import interop
    from jaxlsq_torch.lab.accuracy_parity import make_batch
    from jaxlsq_torch.models import QuantConv, calibrate, mobilenetv2_cifar
    from jaxlsq_torch.serve.matmul import static_int8_conv

    model = chip_smoke._mnv2(torch, "cuda", 8)
    g = torch.Generator(device="cuda").manual_seed(172)
    calibrate(model, [make_batch(chip_smoke.MNV2_B, g, "cuda")[0] for _ in range(4)])
    net = mobilenetv2_cifar(chip_smoke.MNV2_CLASSES, model.qconfig.for_serving("static_int8"),
                            device="cuda")
    interop.load_variables(net, interop.qat_variables(model))
    net.eval()
    del model
    images = make_batch(chip_smoke.MNV2_B, g, "cuda")[0]
    layers = {}

    def keep(mod, inp, out):
        key = (tuple(inp[0].shape), tuple(mod.kernel.packed().orig_shape), tuple(mod.strides),
               mod.groups)
        layers.setdefault(key, [mod, inp[0].clone(), 0])[2] += 1

    hooks = [m.register_forward_hook(keep) for m in net.modules() if isinstance(m, QuantConv)]
    with torch.no_grad():
        net(images)
    for h in hooks:
        h.remove()
    rows = []
    with torch.no_grad():
        ims = [images] + [images.clone() for _ in range(2)]
        rows.append({"kind": "mnv2_forward", "B": chip_smoke.MNV2_B, "ms": min(
            chip_smoke.measure(net, [(x,) for x in ims], 10)[0] for _ in range(2))})
        for (shape, kshape, strides, groups), (mod, x, count) in layers.items():
            packed = mod.kernel.packed()
            a = (mod.act_scale, mod.act_zp, mod.aspec.quant_min, mod.aspec.quant_max)
            xs = [x] + [x.clone() for _ in range(chip_smoke.copies_for(4 * x.numel()) - 1)]
            ms = min(chip_smoke.measure(
                lambda xx: static_int8_conv(xx, packed, *a, strides=mod.strides,
                                            padding=mod.padding, feature_group_count=groups),
                [(xx,) for xx in xs], 20)[0] for _ in range(2))
            rows.append({"kind": "conv", "x": list(shape), "kernel_hwio": list(kshape),
                         "strides": list(strides), "groups": groups, "layers": count,
                         "ms": ms})
    return rows


def int8_bmm_rows(torch, chip_smoke):
    """The checkout's ``static_int8_bmm`` (the MoE LM's experts, E = MOE_E,
    per-expert qparams) at the d1024 MoE's two shapes and capacity C = 1, 8
    and 256 (B = 1 and B = 8 decode, one 256-token prefill; the serving
    capacity is the token count): [{kind, K, N, C, ms}]."""
    from jaxlsq_torch.serve.matmul import static_int8_bmm

    g = torch.Generator(device="cuda").manual_seed(29)
    sx = torch.tensor([0.03], device="cuda")
    z = torch.tensor([128], dtype=torch.int32, device="cuda")
    e = chip_smoke.MOE_E
    rows = []
    for k, n in ((chip_smoke.DIM, 4 * chip_smoke.DIM), (4 * chip_smoke.DIM, chip_smoke.DIM)):
        p = chip_smoke._int8_pack(torch, (e, k, n), g)
        ws = [p.data] + [p.data.clone() for _ in range(chip_smoke.copies_for(e * k * n) - 1)]
        for c in (1, 8, 256):
            x = torch.randn(e, c, k, device="cuda", generator=g)
            ms = min(chip_smoke.measure(
                lambda w: static_int8_bmm(x, w, p.scale, p.zero_point, sx, z, 0, 255),
                [(w,) for w in ws])[0] for _ in range(2))
            rows.append({"kind": "bmm", "E": e, "K": k, "N": n, "C": c, "ms": ms})
    return rows


def int8_decode_rows(torch, chip_smoke):
    """Phase 17's B = 1 decode of the checkout's d1024 x 4 LM at w8
    ('none', 'static_int8', 'dynamic'; ``_slope_tps`` 16 -> 208, least of 3
    rounds): tokens/s of the three modes in turn, twice; then, where the
    checkout quantizes decode rows inside i8mm (``FUSED_MAX_M``),
    'static_int8' and 'dynamic' with the fusion on and off in turns (on,
    off, off, on): {mode: {label: [tokens/s]}}."""
    from jaxlsq_torch.serve import matmul

    served, g = chip_smoke._int8_served_lms(torch, ("none", "static_int8", "dynamic"))
    prompt = torch.randint(0, chip_smoke.VOCAB, (1, chip_smoke.T0), device="cuda",
                           generator=g)

    def tps(model):
        return chip_smoke._slope_tps(torch, model, 1, prompt, torch.bfloat16)[0]

    rows = {mode: {"tokens_per_s_b1": []} for mode in served}
    for _ in range(2):
        for mode, model in served.items():
            rows[mode]["tokens_per_s_b1"].append(tps(model))
    if hasattr(matmul, "FUSED_MAX_M"):
        on = matmul.FUSED_MAX_M
        try:
            for mode in ("static_int8", "dynamic"):
                rows[mode].update(fused=[], unfused=[])
                for fused in (True, False, False, True):
                    matmul.FUSED_MAX_M = on if fused else 0
                    rows[mode]["fused" if fused else "unfused"].append(tps(served[mode]))
        finally:
            matmul.FUSED_MAX_M = on
    return rows


def turn(tree, lab=False, fq_shapes=None, decode=False, int8=False):
    """One checkout's rows: {kind: [row, ...]}."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import jaxlsq_torch  # noqa: F401  (the checkout's package, before chip_smoke's path)
    from jaxlsq_torch import _build

    # this checkout's chip_smoke (the other checkout has one of its own)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    if not torch.cuda.is_available():
        raise SystemExit("wo_compare: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    if lab:
        return lab_rows(torch, chip_smoke)
    if decode:
        return decode_rows(torch, chip_smoke)
    if int8:
        return {"int8": int8_rows(torch, chip_smoke) + int8_bmm_rows(torch, chip_smoke)
                + int8_conv_rows(torch, chip_smoke),
                "int8_decode": int8_decode_rows(torch, chip_smoke)}
    if fq_shapes is not None:
        return fq_rows(torch, chip_smoke, fq_shapes)
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for kind in KINDS:
        rows[kind] = [r for layer, (k, n) in chip_smoke.WO_SHAPES.items()
                      for r in chip_smoke._time_wo(torch, kind, layer, k, n, (1, 8, 256), g)]
        rows[kind] += chip_smoke._time_wo(torch, kind, "k8192", 8192, 8192, (1,), g)
    return rows


def summary(rows):
    if "int8" in rows:
        out = {kind: {f"M{m}_{key}sum_us": 1e3 * sum(r[f"{key}ms"] for r in rows["int8"]
                                                      if r["kind"] == kind and r["M"] == m)
                      for m in (1, 8, 256) for key in ("", "call_")}
               for kind in ("act_quant_i8", "i8mm", "static_layer")}
        out["bmm_us"] = {f"K{r['K']}_N{r['N']}_C{r['C']}": 1e3 * r["ms"]
                         for r in rows["int8"] if r["kind"] == "bmm"}
        convs = [r for r in rows["int8"] if r["kind"] == "conv"]
        out["conv_us"] = {"sum_over_layers": 1e3 * sum(r["ms"] * r["layers"] for r in convs),
                          "depthwise_sum": 1e3 * sum(r["ms"] * r["layers"] for r in convs
                                                     if r["groups"] > 1),
                          "mnv2_forward": 1e3 * next(r["ms"] for r in rows["int8"]
                                                     if r["kind"] == "mnv2_forward")}
        out["decode_tokens_per_s_b1"] = rows["int8_decode"]
        return out
    if "w8" in rows and "tokens_per_s_b1" in rows["w8"]:
        return {k: {"tokens_per_s_b1": r["tokens_per_s_b1"],
                    **({"in_process": r["in_process"]} if "in_process" in r else {})}
                for k, r in rows.items()}
    if "chain_8192x8192" in rows:
        return {case: {k: 1e3 * v for k, v in r.items() if k != "shapes"}
                for case, r in rows.items()}
    if "wo4_bf16" in rows:
        return {kind: {f"M{r['M']}_us": 1e3 * r["ms"] for r in rs} for kind, rs in rows.items()}
    out = {}
    for kind, rs in rows.items():
        d1024 = [r for r in rs if r["layer"] != "k8192"]
        out[kind] = {"M1_sum_us": 1e3 * sum(r["ms"] for r in d1024 if r["M"] == 1),
                     "M8_sum_us": 1e3 * sum(r["ms"] for r in d1024 if r["M"] == 8),
                     "M256_us": {r["layer"]: 1e3 * r["ms"] for r in d1024 if r["M"] == 256},
                     "k8192_M1_us": 1e3 * next(r["ms"] for r in rs if r["layer"] == "k8192")}
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="FIRST_DIR SECOND_DIR")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--lab", action="store_true",
                    help="time the int4 lab kernels instead of wo8/wo4/wo4g")
    ap.add_argument("--fq", action="store_true",
                    help="time the fake-quant kernels instead")
    ap.add_argument("--fq-shapes", help=argparse.SUPPRESS)
    ap.add_argument("--decode", action="store_true",
                    help="phase 3's B = 1 decode tokens/s instead")
    ap.add_argument("--int8", action="store_true",
                    help="time the int8 x int8 kernels (act_quant_i8, i8mm, the static layer)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.turn:
        shapes = json.loads(args.fq_shapes) if args.fq_shapes else None
        print(json.dumps(turn(args.turn, args.lab, shapes, args.decode, args.int8)))
        return 0
    if len(args.trees) != 2:
        ap.error("give two checkouts")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {smi}", flush=True)
    first, second = args.trees
    record = {"card": smi, "lab": args.lab, "fq": args.fq, "decode": args.decode,
              "int8": args.int8, "turns": []}
    extra = (["--lab"] if args.lab else ["--decode"] if args.decode else
             ["--int8"] if args.int8 else [])
    if args.fq:
        extra = ["--fq-shapes", json.dumps({**fq_weight_shapes(), **fq_act_shapes()})]
    for tree in (first, second, second, first):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", tree]
                              + extra, capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"wo_compare: the turn of {tree} failed:\n{proc.stderr}")
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        record["turns"].append({"tree": tree, "summary": summary(rows), "rows": rows})
        print(json.dumps({"tree": tree, **summary(rows)}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
