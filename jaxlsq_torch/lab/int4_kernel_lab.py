"""The int4 weight-only matmul lab (port of ``examples/_int4_kernel_lab.py``).

Two candidate int4 designs, measured at serving shapes beside the shipped
``wo8`` and ``wo4`` kernels (``serve.matmul.wo_matmul``):

* ``int4_bf16`` (:func:`run_bf16`, kernel ``wo4_bf16``): the serving pack's
  split-half int4 bytes, x and the nibble planes in bf16, products summed in
  f32, times the per-column scale (symmetric, no zero point);
* ``int4_native`` (:func:`run_native`, kernel ``wo4_native``): int4 with K
  contiguous (:func:`pack_native`: byte ``(k // 2, n)`` holds row ``2k`` in
  its low nibble and row ``2k + 1`` in its high nibble; odd K raises), one
  f32 product per K step, times the per-column scale.

On a CUDA tensor ``run_bf16``/``run_native`` launch the int4 kernels' first
design in ``csrc/wo_matmul.cu`` (chunked blocks, partials and an epilogue
over a workspace) with the lab's staging of x and no zero point
(``jlt_wo4_lab``) or raise; on a CPU tensor they run their plain versions
:func:`run_bf16_plain` and :func:`run_native_plain`.  ``LAUNCHES`` counts
the launches.

:func:`run_lab` (and ``main``, its command line) checks each variant against
``wo_matmul_plain`` at its own bits and times it on the card with
:func:`lab.timing.measure <jaxlsq_torch.lab.timing.measure>` (device ms from
CUDA events around calls queued behind a sleep kernel, the weights rotated
through enough copies to exceed the 50 MB L2), min of rounds; weight GB/s is
the weight bytes over that time.  The TPU lab's chained-jit slope does not
carry over.  On the card::

    python -m jaxlsq_torch.lab.int4_kernel_lab [--m 16,128] [--k 8192] [--n 8192]
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Dict, Iterable

import numpy as np
import torch

from .. import _build
from ..core.spec import QuantSpec
from ..serve.matmul import wo_matmul, wo_matmul_plain
from ..serve.pack import PackedWeight, dequantize_weight, quantize_weight, unpack_int4
from .timing import measure

__all__ = ["LAUNCHES", "pack_native", "unpack_native", "run_bf16", "run_native",
           "run_bf16_plain", "run_native_plain", "lab_weights", "run_lab", "main"]

LAUNCHES = {"wo4_bf16": 0, "wo4_native": 0}


def pack_native(q: torch.Tensor) -> torch.Tensor:
    """(K, N) integer values in [-8, 7] -> (K / 2, N) int8 bytes, rows
    ``2k`` and ``2k + 1`` in the low and high nibble of byte row ``k``."""
    if q.dim() != 2 or q.shape[0] % 2:
        raise ValueError(f"pack_native needs a (K, N) tensor with K even, got "
                         f"{tuple(q.shape)}")
    if q.is_floating_point() or (q.numel() and (int(q.min()) < -8 or int(q.max()) > 7)):
        raise ValueError("pack_native: expected integer values in [-8, 7]")
    q = q.to(torch.int8)
    return ((q[0::2] & 0x0F) | (q[1::2] << 4)).to(torch.int8)


def unpack_native(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_native`, sign-extending both nibbles."""
    lo, hi = (p << 4) >> 4, p >> 4  # int8 arithmetic shifts sign-extend
    return torch.stack([lo, hi], dim=1).reshape(2 * p.shape[0], p.shape[1])


def run_bf16_plain(x2d: torch.Tensor, packed: PackedWeight) -> torch.Tensor:
    """bf16(x) @ the bf16 nibble planes, summed in f32, times the scale."""
    k = packed.orig_shape[0]
    q = unpack_int4(packed.data, 0)[:k]
    xb = x2d.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(xb, q.to(torch.float32)) * packed.scale.to(torch.float32)


def run_native_plain(x2d: torch.Tensor, w4: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """x @ the unpacked int4 values in f32, times the scale."""
    q = unpack_native(w4).to(torch.float32)
    return torch.matmul(x2d.to(torch.float32), q) * scale.to(torch.float32)


def _launch(name: str, x2d: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
            k: int, n: int, native: bool) -> torch.Tensor:
    dev = x2d.device
    if x2d.dtype != torch.float32 or x2d.dim() != 2 or x2d.shape[1] != k:
        raise ValueError(f"{name}: x must be (M, {k}) float32, got "
                         f"{tuple(x2d.shape)} {x2d.dtype}")
    rows = k // 2 if native else (k + 1) // 2
    if w.dtype != torch.int8 or tuple(w.shape) != (rows, n):
        raise ValueError(f"{name}: weight bytes must be ({rows}, {n}) int8, got "
                         f"{tuple(w.shape)} {w.dtype}")
    if scale.numel() != n:
        raise ValueError(f"{name}: the scale must have {n} elements")
    for t in (w, scale):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    x2d, w = x2d.contiguous(), w.contiguous()
    if w.data_ptr() % 4:
        raise ValueError(f"{name}: weight bytes must be 4-byte aligned")
    scale = scale.to(torch.float32).contiguous()
    m = x2d.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    lib = _build.load_library()
    chunk, slab = lib.jlt_wo_chunk_rows(), lib.jlt_wo_slab_rows()
    part = torch.empty(-(-rows // chunk) * min(m, slab) * n, dtype=torch.float32,
                       device=dev)
    err = lib.jlt_wo4_lab(x2d.data_ptr(), w.data_ptr(), scale.data_ptr(),
                          out.data_ptr(), part.data_ptr(), m, k, n, int(native),
                          torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES[name] += 1
    _build.check(err, name)
    return out


def run_bf16(x2d: torch.Tensor, packed: PackedWeight) -> torch.Tensor:
    """``wo4_bf16`` on a symmetric split-half int4 ``PackedWeight`` with a
    (N,) scale (its zero point is not read): (M, N) f32."""
    if packed.bits != 4 or len(packed.orig_shape) != 2 or packed.group_size:
        raise ValueError("run_bf16 needs a per-channel int4 (K, N) PackedWeight")
    k, n = packed.orig_shape
    if x2d.device.type == "cpu":
        return run_bf16_plain(x2d, packed)
    if x2d.device.type != "cuda":
        raise ValueError(f"run_bf16: unsupported device {x2d.device}")
    return _launch("wo4_bf16", x2d, packed.data, packed.scale, k, n, native=False)


def run_native(x2d: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``wo4_native`` on :func:`pack_native` bytes (K / 2, N) and a (N,)
    scale: (M, N) f32."""
    k, n = 2 * w4.shape[0], w4.shape[1]
    if x2d.device.type == "cpu":
        return run_native_plain(x2d, w4, scale)
    if x2d.device.type != "cuda":
        raise ValueError(f"run_native: unsupported device {x2d.device}")
    return _launch("wo4_native", x2d, w4, scale, k, n, native=True)


def lab_weights(k: int, n: int, device):
    """The lab's seeded weights (the JAX lab's own draw, seed 1): ``(p8, p4,
    w4, scale, rng)`` with int8 and int4 ``PackedWeight``s of ``0.02 *
    randn(k, n)`` at per-column scales ``0.001 + 0.0005 * rand(n)``, the same
    int4 values packed K-contiguous, and the generator for the
    activations."""
    r = np.random.RandomState(1)
    w = torch.from_numpy(0.02 * r.randn(k, n).astype(np.float32)).to(device)
    scale = torch.from_numpy(0.001 + 0.0005 * r.rand(n).astype(np.float32)).to(device)
    zp = torch.zeros(n, device=device)
    spec4 = QuantSpec.make(4, signed=True, symmetric=True, per_channel=True, axis=1)
    spec8 = QuantSpec.make(8, signed=True, symmetric=True, per_channel=True, axis=1)
    p8 = quantize_weight(w, scale, zp, spec8, bits=8)
    p4 = quantize_weight(w, scale, zp, spec4, bits=4)
    q = torch.round(torch.clamp(w / scale, -8, 7)).to(torch.int8)
    return p8, p4, pack_native(q), p4.scale.to(torch.float32), r


def _rel(y: torch.Tensor, ref: torch.Tensor) -> float:
    return float((y - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def _abs(y: torch.Tensor, ref: torch.Tensor) -> float:
    return float((y - ref).abs().max())


def run_lab(ms: Iterable[int], k: int = 8192, n: int = 8192,
            rounds: int = 10) -> Dict[str, dict]:
    """On the card, per M: each variant's error against ``wo_matmul_plain``
    at its own bits, the two lab kernels' errors against their plain
    versions and ``wo4_native``'s against ``wo4`` on the same values, and the
    device ms and weight GB/s of every variant, of the two plain versions
    and of two library matmuls on dequantized weights (f32; bf16 x and
    weights, bf16 out)."""
    dev, reps = torch.device("cuda"), 20
    p8, p4, w4, sc, r = lab_weights(k, n, dev)
    copies = max(1, math.ceil(160e6 / (k * n / 2)))  # rotate past the L2
    p4s = [p4] + [PackedWeight(p4.data.clone(), p4.scale, p4.zero_point, 4, 1, 0,
                               p4.orig_shape) for _ in range(copies - 1)]
    p8s = [p8] + [PackedWeight(p8.data.clone(), p8.scale, p8.zero_point, 8, 1, 0,
                               p8.orig_shape) for _ in range(copies - 1)]
    w4s = [w4] + [w4.clone() for _ in range(copies - 1)]
    w32 = dequantize_weight(p4)
    w16 = w32.to(torch.bfloat16)
    results = {}
    for m in ms:
        x = torch.from_numpy(r.randn(m, k).astype(np.float32)).to(dev)
        ref8, ref4 = wo_matmul_plain(x, p8), wo_matmul_plain(x, p4)
        variants = {
            "int8": (lambda p: wo_matmul(x, p), [(p,) for p in p8s], ref8, k * n),
            "int4_cur": (lambda p: wo_matmul(x, p), [(p,) for p in p4s], ref4, k * n // 2),
            "int4_bf16": (lambda p: run_bf16(x, p), [(p,) for p in p4s], ref4, k * n // 2),
            "int4_native": (lambda w: run_native(x, w, sc), [(w,) for w in w4s], ref4,
                            k * n // 2),
        }
        out = {name: {"max_rel_err": _rel(fn(*args[0]), ref), "w_bytes": wb}
               for name, (fn, args, ref, wb) in variants.items()}
        bf, nat = run_bf16(x, p4), run_native(x, w4, sc)
        cur = wo_matmul(x, p4)
        for name, y, ref in (("int4_bf16", bf, run_bf16_plain(x, p4)),
                             ("int4_native", nat, run_native_plain(x, w4, sc))):
            out[name].update(rel_err_vs_plain=_rel(y, ref), abs_err_vs_plain=_abs(y, ref))
        out["int4_native"]["rel_err_vs_int4_cur"] = _rel(nat, cur)
        for name, (fn, args, _, wb) in variants.items():
            t = min(measure(fn, args, reps)[0] for _ in range(rounds))
            out[name].update(ms=t, w_gbps=wb / t / 1e6)
        xs16 = x.to(torch.bfloat16)
        for name, fn, args in (
                ("int4_bf16_plain", lambda p: run_bf16_plain(x, p), [(p4,)]),
                ("int4_native_plain", lambda w: run_native_plain(x, w, sc), [(w4,)]),
                ("lib_matmul_f32", lambda w: torch.matmul(x, w), [(w32,)]),
                ("lib_matmul_bf16", lambda w: torch.matmul(xs16, w), [(w16,)])):
            out[name] = {"ms": min(measure(fn, args, max(2, reps // 4))[0]
                                   for _ in range(max(1, rounds // 2)))}
        results[f"M{m}"] = out
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", default="16,128")
    ap.add_argument("--k", type=int, default=8192)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int4_kernel_lab: no CUDA device; the lab times kernels "
                         "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = run_lab([int(v) for v in args.m.split(",")], args.k, args.n, args.rounds)
    for m, out in res.items():
        print(f"{m}:", json.dumps(out), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), **res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
