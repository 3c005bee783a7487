"""Tracing and profiling hooks (port of ``jaxlsq/utils/profiling.py``).

``torch.profiler`` in place of ``jax.profiler``: :func:`annotate` names a span
(``torch.profiler.record_function``, plus an NVTX range when a CUDA card is
present), :func:`trace` records the enclosed block over the CPU and the card
and writes a Chrome trace into a directory, and :class:`StepTimer` is a
steps/s meter that waits for the card only on the stream of its probe.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

__all__ = ["annotate", "trace", "StepTimer"]


class annotate(contextlib.ContextDecorator):
    """A named span, as a context manager or a decorator: a
    ``record_function`` range (seen by ``torch.profiler``; nothing is
    recorded outside a profile) and, with a CUDA card, an NVTX range."""

    def __init__(self, name: str):
        self.name = name
        self._open = []

    def __enter__(self):
        rf = torch.profiler.record_function(self.name)
        rf.__enter__()
        self._open.append(rf)
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_pop()
        self._open.pop().__exit__(*exc)
        return False


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (CPU, and CUDA where a card is present) and
    write it as a Chrome trace ``trace_<pid>_<ms>.json`` into ``log_dir``
    (view with Perfetto or chrome://tracing); yields the profiler (its
    ``key_averages()``, and ``trace_path`` once the block has ended)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.trace_path = os.path.join(
            log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
        prof.export_chrome_trace(prof.trace_path)


def _wait(probe) -> None:
    """Wait for the current stream of each CUDA device among the tensors of
    ``probe`` (a tensor, or a list, tuple or dict of them)."""
    if isinstance(probe, dict):
        probe = list(probe.values())
    if isinstance(probe, (list, tuple)):
        for p in probe:
            _wait(p)
    elif torch.is_tensor(probe) and probe.is_cuda:
        torch.cuda.current_stream(probe.device).synchronize()


class StepTimer:
    """Host-side steps/s meter with warm-up exclusion.  Each ``tick`` waits
    for its probe's stream first, so the rate is the card's, not the
    dispatch's."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._count = 0
        self._t0: Optional[float] = None
        self._timed_steps = 0

    def tick(self, probe=None) -> Optional[float]:
        """Call once per step; returns steps/s so far (None during the
        warm-up and at the first timed tick).  ``probe``: a device value of
        the step to wait for before reading the clock."""
        if probe is not None:
            _wait(probe)
        self._count += 1
        if self._count <= self.warmup:
            return None
        if self._t0 is None:
            self._t0 = time.perf_counter()
            self._timed_steps = 0
            return None
        self._timed_steps += 1
        dt = time.perf_counter() - self._t0
        return self._timed_steps / dt if dt > 0 else None
