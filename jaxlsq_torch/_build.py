"""Build and load the port's CUDA kernels at first use.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The library name carries a
hash of the sources and flags, so an edited source is rebuilt.  The build
directory ``jaxlsq_torch/_build/`` is not tracked by git.  A failed build raises with the compiler's output; nothing
falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["load_library", "check"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC"]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (pointers and the stream as
# c_void_p: a bare Python int would be passed as a 32-bit int).
_SIGNATURES = {
    # x, w, scale, zp, out, M, K, N, per_channel, stream
    "jlt_wo8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, w, scale, zp, out, M, K, N, per_channel, group_size, stream
    "jlt_wo4": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, kd, ks, vd, vs, qpos, out, ws, B, KVH, L, hd, t, gt, window,
    # carrier, scale, stream
    "jlt_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, ctypes.c_float, _P],
    # q, kp, ks, vp, vs, qpos, table, out, ws, B, KVH, ps, pps, hd, t, gt,
    # window, carrier, scale, stream
    "jlt_paged_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, ctypes.c_float, _P],
    # x, scale, shift, out, n, qmin, qmax, tmin, tmax, stream
    "jlt_fq_fwd_pt": [_P, _P, _P, _P, _I, _F, _F, _F, _F, _P],
    # x, scale, shift, out, outer, C, inner, span, qmin, qmax, tmin, tmax, stream
    "jlt_fq_fwd_pc": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P],
    # g, x, scale, shift, dx, ds, db, n, slot, qmin, qmax, tmin, tmax, sym,
    # eval, init, gs, stream
    "jlt_fq_bwd_pt": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _I,
                      _I, _I, _F, _P],
    # g, x, scale, shift, dx, ds, db, outer, C, inner, warps, cluster, qmin,
    # qmax, tmin, tmax, sym, eval, init, gs, stream
    "jlt_fq_bwd_pc": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                      _F, _F, _I, _I, _I, _F, _P],
    # g, x, scale, shift, out, dx, ds, db, n, slot, qmin, qmax, tmin, tmax,
    # sym, gs, stream
    "jlt_fq_fwdbwd_pt": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F,
                         _I, _F, _P],
    # g, x, scale, shift, out, dx, ds, db, outer, C, inner, warps, cluster,
    # qmin, qmax, tmin, tmax, sym, gs, stream
    "jlt_fq_fwdbwd_pc": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                         _F, _F, _F, _I, _F, _P],
    # x, w, scale, out, M, K, N, native, stream
    "jlt_int4_lab": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, scale, shift, flags, out, n, qmin, qmax, tmin, tmax, stream
    "jlt_fq_fwd_pt_traced": [_P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _P],
    # x, scale, shift, flags, out, outer, C, inner, span, qmin, qmax, tmin,
    # tmax, stream
    "jlt_fq_fwd_pc_traced": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P],
    # g, x, scale, shift, flags, dx, ds, db, n, slot, qmin, qmax, tmin, tmax,
    # sym, gs, stream
    "jlt_fq_bwd_pt_traced": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F,
                             _F, _I, _F, _P],
    # g, x, scale, shift, flags, dx, ds, db, outer, C, inner, warps,
    # cluster, qmin, qmax, tmin, tmax, sym, gs, stream
    "jlt_fq_bwd_pc_traced": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _F, _F, _F, _F, _I, _F, _P],
    # q, k, v, out, lse, BH, t, hd, sm_scale, stream
    "jlt_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    # q, k, v, dout, lse, D, dq, dk, dv, BH, t, hd, sm_scale, stream
    "jlt_flash_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith((".cu", ".cuh")))


def _build() -> str:
    srcs = _sources()
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    tag = h.hexdigest()[:16]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"libjaxlsq_torch_{tag}.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    procs = []
    for src in (s for s in srcs if s.endswith(".cu")):
        obj = os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *_FLAGS, "-I", _CSRC, "-c", src, "-o", obj]
        procs.append((obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for obj, cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [nvcc, *_FLAGS[:2], "-shared", "-o", tmp] + [o for o, _, _ in procs]
    link = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n{link.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name in ("jlt_wo4_group_rows", "jlt_attention_span_keys",
                         "jlt_fq_pt_slots"):
                getattr(lib, name).restype = ctypes.c_int
            lib.group_rows = lib.jlt_wo4_group_rows()
            lib.span_keys = lib.jlt_attention_span_keys()
            lib.pt_slots = lib.jlt_fq_pt_slots()
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error (its cudaGetLastError)."""
    if err != 0:
        lib = load_library()
        lib.jlt_error_string.restype = ctypes.c_char_p
        lib.jlt_error_string.argtypes = [_I]
        msg = lib.jlt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
