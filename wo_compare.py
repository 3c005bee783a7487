#!/usr/bin/env python3
"""Time the weight-only matmul kernels (``wo8``, ``wo4``, ``wo4g``), or with
``--lab`` the int4 lab's two kernels (``wo4_bf16``, ``wo4_native``), or with
``--fq`` the fake-quant kernels (forward, backward and fused, per tensor
and per channel), of two checkouts of this repo on
one card, in turns (first, second, second, first), so that two versions are
compared within one run on one card:

    python3 wo_compare.py FIRST_DIR SECOND_DIR [--lab | --fq] [--out PATH]

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
turn (µs).
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


def turn(tree, lab=False, fq_shapes=None):
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
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.turn:
        shapes = json.loads(args.fq_shapes) if args.fq_shapes else None
        print(json.dumps(turn(args.turn, args.lab, shapes)))
        return 0
    if len(args.trees) != 2:
        ap.error("give two checkouts")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {smi}", flush=True)
    first, second = args.trees
    record = {"card": smi, "lab": args.lab, "fq": args.fq, "turns": []}
    extra = ["--lab"] if args.lab else []
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
