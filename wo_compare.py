#!/usr/bin/env python3
"""Time the weight-only matmul kernels (``wo8``, ``wo4``, ``wo4g``) of two
checkouts of this repo on one card, in turns (first, second, second, first),
so that two versions are compared within one run on one card:

    python3 wo_compare.py FIRST_DIR SECOND_DIR [--out PATH]

Each turn is a process of its own that imports the checkout's
``jaxlsq_torch`` (building its kernels) and times them with this file's
checkout's ``chip_smoke._time_wo`` (device time from CUDA events, the
weights rotated past the L2; seeded weights, the same in every turn): the
five d1024 layer shapes at M = 1, 8 and 256, and K = N = 8192 at M = 1.
Prints one summary line a turn (µs: the M = 1 and M = 8 sums over the five
shapes, each shape at M = 256, K = N = 8192) and writes every row to
``--out`` as JSON.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
KINDS = ("wo8", "wo4", "wo4g")


def turn(tree):
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
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for kind in KINDS:
        rows[kind] = [r for layer, (k, n) in chip_smoke.WO_SHAPES.items()
                      for r in chip_smoke._time_wo(torch, kind, layer, k, n, (1, 8, 256), g)]
        rows[kind] += chip_smoke._time_wo(torch, kind, "k8192", 8192, 8192, (1,), g)
    return rows


def summary(rows):
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
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(turn(args.turn)))
        return 0
    if len(args.trees) != 2:
        ap.error("give two checkouts")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {smi}", flush=True)
    first, second = args.trees
    record = {"card": smi, "turns": []}
    for tree in (first, second, second, first):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", tree],
                              capture_output=True, text=True)
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
