"""Continuous-batching serving engine (port of ``ServingEngine`` from
``jaxlsq/serve/engine.py``).

* Requests are enqueued from any thread (``submit`` returns a Future that
  resolves to the example's output row as a numpy array).
* A dispatcher thread drains the queue continuously: whatever arrived is
  padded with zero rows up to the nearest power-of-two batch bucket and run;
  requests that arrive while a batch runs form the next one.
* On the card each bucket is one CUDA graph (the JAX package's one compiled
  program a bucket): a static input and output buffer a bucket, captured at
  :meth:`ServingEngine.warmup` or at the bucket's first use, then each batch
  is copied into the input and the graph replayed; the output is copied to
  the host before the next replay reuses it.  There is no eager fallback:
  a forward that cannot be captured fails its batch.  On the CPU
  ``apply_fn`` runs directly.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["ServingEngine"]


class _Request:
    __slots__ = ("x", "future")

    def __init__(self, x):
        self.x = x
        self.future: Future = Future()


class _Graph:
    """One bucket's captured forward and its static buffers."""

    __slots__ = ("graph", "x", "out", "host_x")

    def __init__(self, graph, x, out, host_x):
        self.graph, self.x, self.out, self.host_x = graph, x, out, host_x


class ServingEngine:
    """Continuous-batching wrapper around a per-example model function.

    Args:
      apply_fn: ``(batch_x) -> batch_out`` over a LEADING batch axis, on
        ``device`` (e.g. a serve-mode model); it runs under ``no_grad``.
      example_shape: per-example input shape (no batch axis).
      max_batch: largest bucket (power-of-two buckets from 1 up to it).
      max_wait_ms: how long the idle dispatcher waits for a request before
        it checks again for a close.
      dtype: the input dtype.
      device: where ``apply_fn`` runs; CUDA unless the caller names another.

    ``stats``: ``requests``, ``batches``, ``padded_examples`` (zero rows
    run), and ``batch_sizes`` (the requests of each recent batch, in order).
    ``captures`` counts the graphs captured a bucket.
    """

    def __init__(self, apply_fn: Callable, example_shape: Sequence[int], *,
                 max_batch: int = 64, max_wait_ms: float = 2.0,
                 dtype=torch.float32, device=None):
        self._fn = apply_fn
        self.example_shape = tuple(example_shape)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.buckets = []
        b = 1
        while b <= max_batch:
            self.buckets.append(b)
            b *= 2
        self.max_batch = self.buckets[-1]
        self.max_wait_s = max_wait_ms / 1e3
        self._graphs: dict = {}
        self.captures = {b: 0 for b in self.buckets}
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._stats_lock = threading.Lock()
        # one batch or one capture on the device at a time
        self._run_lock = threading.Lock()
        # Serializes submit() against close() so a request can never be
        # enqueued after the close sentinel (whose leftovers flush would
        # otherwise miss it, leaving its Future unresolved forever).
        self._lifecycle_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "padded_examples": 0,
                      "batch_sizes": deque(maxlen=4096)}
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ API

    def submit(self, x) -> Future:
        """Enqueue one example (shape == example_shape); returns a Future
        resolving to the model output for that example."""
        x = np.asarray(x)
        if x.shape != self.example_shape:
            raise ValueError(
                f"expected example shape {self.example_shape}, got {x.shape}")
        req = _Request(x)
        with self._lifecycle_lock:
            if self._stop:
                raise RuntimeError("ServingEngine is closed")
            self._queue.put(req)
        return req.future

    def submit_many(self, xs) -> list:
        return [self.submit(x) for x in xs]

    def warmup(self):
        """Run every bucket once up front: on the card, capture its graph."""
        for b in self.buckets:
            with self._run_lock:
                self._forward(torch.zeros((b,) + self.example_shape, dtype=self.dtype))

    def close(self):
        with self._lifecycle_lock:
            already = self._stop
            self._stop = True
            if not already:
                self._queue.put(None)  # wake the dispatcher
        self._thread.join(timeout=60)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------------- device

    @torch.no_grad()
    def _capture(self, x: torch.Tensor) -> _Graph:
        """Warm ``apply_fn`` up on a side stream with ``x``, then capture it
        over a static copy of ``x``."""
        dev = self.device
        static_x = x.to(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._fn(static_x)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._fn(static_x)
        host_x = torch.empty(static_x.shape, dtype=static_x.dtype, pin_memory=True)
        self.captures[x.shape[0]] += 1
        return _Graph(graph, static_x, out, host_x)

    @torch.no_grad()
    def _forward(self, x: torch.Tensor) -> np.ndarray:
        """The outputs of one padded bucket batch ``x`` (a host tensor), on
        the host."""
        if self.device.type != "cuda":
            return self._fn(x.to(self.device)).cpu().numpy()
        g = self._graphs.get(x.shape[0])
        if g is None:
            g = self._graphs[x.shape[0]] = self._capture(x)
        g.host_x.copy_(x)
        g.x.copy_(g.host_x, non_blocking=True)
        g.graph.replay()
        return g.out.cpu().numpy()  # before the next replay reuses it

    # ------------------------------------------------------------ dispatcher

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def _drain(self, first: _Request) -> list:
        batch = [first]
        while len(batch) < self.max_batch:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is None:
                self._stop = True
                break
            batch.append(req)
        return batch

    def _loop(self):
        while not self._stop:
            try:
                first = self._queue.get(timeout=self.max_wait_s)
            except queue.Empty:
                continue
            if first is None:
                break
            self._run(self._drain(first))
        # flush whatever remains after close()
        leftovers = []
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                leftovers.append(req)
        for i in range(0, len(leftovers), self.max_batch):
            self._run(leftovers[i:i + self.max_batch])

    def _run(self, batch: list):
        n = len(batch)
        bucket = self._bucket_for(n)
        try:
            x = torch.zeros((bucket,) + self.example_shape, dtype=self.dtype)
            for i, req in enumerate(batch):
                x[i] = torch.from_numpy(np.asarray(req.x))
            with self._run_lock:
                out = self._forward(x)
            for i, req in enumerate(batch):
                req.future.set_result(out[i])
        except Exception as e:  # propagate to every waiter in the batch
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)
            return
        with self._stats_lock:
            self.stats["requests"] += n
            self.stats["batches"] += 1
            self.stats["padded_examples"] += bucket - n
            self.stats["batch_sizes"].append(n)
