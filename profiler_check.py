#!/usr/bin/env python3
"""How often ``torch.profiler`` loses kernel records on one NVIDIA GPU.

    python3 profiler_check.py [--no-teardown]

Profiles 150 rounds of short sessions (CUDA activity only, 40 calls each)
of four functions: an f32 ``torch.matmul`` at M = 256 and at M = 1
(cuBLAS), the port's ``wo_matmul`` (int4, M = 8) and its per-tensor
fake-quant forward.
Each session's kernel time is held against a reference taken without the
profiler: CUDA events around the same calls issued behind a sleep kernel,
so they run back to back.  A session is "ok" at half the reference or
more, "partial" below that, "miss" when it recorded no kernel.
``--no-teardown`` sets ``TEARDOWN_CUPTI=0``, so the profiler keeps CUPTI
set up between sessions instead of tearing it down after each.

Prints one line per function and last one JSON object with the counts.
Needs one CUDA card; imports no jax.
"""

import argparse
import json
import os
import sys
import time

REPS = 40
ROUNDS = 150
CYCLES_PER_MS = 2.0e6  # the H100's top SM clock; at a lower clock a sleep lasts longer


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-teardown", action="store_true")
    args = parser.parse_args(argv)
    if args.no_teardown:
        os.environ["TEARDOWN_CUPTI"] = "0"

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profiler_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from jaxlsq_torch.core.spec import QuantSpec
    from jaxlsq_torch.models import default_qconfig
    from jaxlsq_torch.ops.fake_quant import fake_quant_forward
    from jaxlsq_torch.serve.matmul import wo_matmul
    from jaxlsq_torch.serve.pack import quantize_weight

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(256, 1024, device=dev, generator=g)
    w = torch.randn(1024, 3072, device=dev, generator=g) * 0.03
    spec4 = QuantSpec.weight_default(4, per_channel=True, axis=1)
    p = quantize_weight(w, w.abs().amax(0) / spec4.quant_max,
                        torch.zeros(3072, device=dev), spec4, bits=4)
    xa = torch.randn(64, 64, 32, 32, device=dev, generator=g)
    s, b = torch.full((1,), 0.05, device=dev), torch.zeros(1, device=dev)
    aspec = default_qconfig(8, 8).activation.spec
    fns = {"matmul_m256": lambda: torch.matmul(x, w),
           "matmul_m1": lambda: torch.matmul(x[:1], w),
           "wo4_m8": lambda: wo_matmul(x[:8], p),
           "fq_fwd_pt": lambda: fake_quant_forward(xa, s, b, aspec)}

    def run_all(fn):
        for _ in range(REPS):
            fn()

    def reference_us(fn):
        run_all(fn)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(30 * CYCLES_PER_MS))
        e0.record()
        run_all(fn)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) * 1e3 / REPS

    card = torch.cuda.get_device_name(0)
    ref = {k: reference_us(f) for k, f in fns.items()}
    stats = {k: {"ok": 0, "partial": 0, "miss": 0, "lost": []} for k in fns}
    t0 = time.time()
    for r in range(ROUNDS):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run_all(fn)
                torch.cuda.synchronize()
            rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            us = sum(e.self_device_time_total for e in rows) / REPS
            kind = "miss" if us == 0 else "partial" if us < 0.5 * ref[k] else "ok"
            stats[k][kind] += 1
            if kind != "ok":
                stats[k]["lost"].append({"round": r, "us": us,
                                         "kernels": sum(e.count for e in rows)})
    wall = time.time() - t0
    for k, v in stats.items():
        print(f"[profiler_check] {k}: reference {ref[k]:.2f} us a call; "
              f"{v['ok']} ok, {v['partial']} partial, {v['miss']} miss of "
              f"{ROUNDS} sessions; lost: {v['lost']}", flush=True)
    print(json.dumps({"card": card, "teardown_cupti": not args.no_teardown,
                      "rounds": ROUNDS, "wall_s": wall, "reference_us": ref,
                      "stats": stats}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
