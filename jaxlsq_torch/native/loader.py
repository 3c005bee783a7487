"""NativeShardLoader: the C++ prefetching shard loader (port of
``jaxlsq/native/loader.py``), yielding torch tensors.

Worker threads in ``loader.cpp`` gather shuffled rows from memory-mapped
``.npy`` shards into a ring of prefetched batch buffers; :meth:`next` copies
the next batch out of the ring into host tensors (pinned when a CUDA card is
present) and, when the loader was given a ``device``, starts their
``non_blocking`` copy to it on the current stream.  A pinned host tensor is
allocated anew each batch through PyTorch's caching host allocator, which
does not hand its memory out again before the copy that read it has ended.

Determinism contract (the JAX package's): for a given ``seed``, batch ``k``
always holds rows ``perm_epoch[k*B:(k+1)*B]`` of the global (shard, row)
index, independent of ``workers``/``prefetch`` (the ring delivers in order).

Usage::

    with NativeShardLoader([("x0.npy", "y0.npy"), ...], batch=128, seed=0,
                           workers=4, device="cuda") as ld:
        for _ in range(steps):
            x, y = ld.next()          # tensors on the card
            step({"image": x, "label": y})
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .build import load_library

__all__ = ["NativeShardLoader"]

_LIB: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = load_library("jlloader")
        lib.jl_open.restype = ctypes.c_void_p
        lib.jl_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_ulonglong, ctypes.c_char_p, ctypes.c_long]
        for name in ("jl_x_row_bytes", "jl_y_row_bytes", "jl_num_examples",
                     "jl_batches_per_epoch", "jl_delivered"):
            getattr(lib, name).restype = ctypes.c_long
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.jl_next.restype = ctypes.c_int
        lib.jl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.jl_close.restype = None
        lib.jl_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _npy_meta(path: str) -> Tuple[np.dtype, Tuple[int, ...]]:
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    if fortran:
        raise ValueError(f"fortran-order npy unsupported: {path}")
    return dtype, shape


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class NativeShardLoader:
    """Prefetching shuffled batch stream over .npy shard pairs (or unlabeled
    shards), as torch tensors on ``device`` (the host when None)."""

    def __init__(self, shards: Sequence, batch: int, *, seed: int = 0,
                 workers: int = 2, prefetch: int = 4, device=None):
        lib = _load()
        pairs = [(s, None) if isinstance(s, str) else tuple(s) for s in shards]
        if not pairs:
            raise ValueError("no shards given")
        self._has_y = pairs[0][1] is not None
        if any((p[1] is not None) != self._has_y for p in pairs):
            raise ValueError("either all shards have labels or none do")
        x_dtype, x_shape = _npy_meta(pairs[0][0])
        self.x_shape = (batch,) + tuple(x_shape[1:])
        self.x_dtype = x_dtype
        if self._has_y:
            y_dtype, y_shape = _npy_meta(pairs[0][1])
            self.y_shape = (batch,) + tuple(y_shape[1:])
            self.y_dtype = y_dtype
        # every shard must match shard 0's dtype and inner shape: the native
        # layer checks only row byte sizes
        for xp_path, yp_path in pairs[1:]:
            d, sh = _npy_meta(xp_path)
            if d != x_dtype or tuple(sh[1:]) != tuple(x_shape[1:]):
                raise ValueError(f"shard {xp_path}: dtype/shape {d}{sh[1:]} != shard0 "
                                 f"{x_dtype}{tuple(x_shape[1:])}")
            if self._has_y:
                d, sh = _npy_meta(yp_path)
                if d != y_dtype or tuple(sh[1:]) != tuple(y_shape[1:]):
                    raise ValueError(f"shard {yp_path}: dtype/shape {d}{sh[1:]} != shard0 "
                                     f"{y_dtype}{tuple(y_shape[1:])}")
        self.device = None if device is None else torch.device(device)
        self._pin = torch.cuda.is_available()
        xp = (ctypes.c_char_p * len(pairs))(*[p[0].encode() for p in pairs])
        yp = None
        if self._has_y:
            yp = (ctypes.c_char_p * len(pairs))(*[p[1].encode() for p in pairs])
        err = ctypes.create_string_buffer(512)
        self._h = lib.jl_open(xp, yp, len(pairs), batch, prefetch, workers, seed, err,
                              len(err))
        if not self._h:
            raise RuntimeError(f"NativeShardLoader: {err.value.decode()}")
        self._lib = lib
        self.batch = batch
        self.num_examples = lib.jl_num_examples(self._h)
        self.batches_per_epoch = lib.jl_batches_per_epoch(self._h)
        row = int(np.prod(self.x_shape[1:], dtype=np.int64)) * x_dtype.itemsize
        if lib.jl_x_row_bytes(self._h) != row:
            raise RuntimeError("NativeShardLoader: the native row size disagrees with "
                               "the npy header")

    def _host(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=_torch_dtype(dtype), pin_memory=self._pin)

    def next(self):
        """The next batch: x or (x, y), host tensors, or on ``device`` (their
        copies started ``non_blocking`` on the current stream)."""
        if self._h is None:
            # jl_next would dereference a NULL handle
            raise RuntimeError("NativeShardLoader is closed")
        x = self._host(self.x_shape, self.x_dtype)
        y = self._host(self.y_shape, self.y_dtype) if self._has_y else None
        rc = self._lib.jl_next(self._h, ctypes.c_void_p(x.data_ptr()),
                               ctypes.c_void_p(y.data_ptr()) if y is not None else None)
        if rc != 0:
            raise RuntimeError("loader stopped")
        if self.device is not None:
            x = x.to(self.device, non_blocking=True)
            y = y.to(self.device, non_blocking=True) if y is not None else None
        return (x, y) if self._has_y else x

    def __iter__(self):
        while True:
            yield self.next()

    @property
    def delivered(self) -> int:
        if self._h is None:
            raise RuntimeError("NativeShardLoader is closed")
        return self._lib.jl_delivered(self._h)

    def close(self):
        if self._h:
            self._lib.jl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
