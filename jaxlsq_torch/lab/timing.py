"""Device time of calls on the card, the one method behind every time that
``chip_smoke.py`` and the kernel labs report.

* :func:`events_ms`: CUDA events around a run, optionally queued behind a
  sleep kernel so the run's kernels go back to back on the device;
* :func:`measure`: device ms and call ms per call of a function cycled
  through copies of its inputs (so the working set exceeds the 50 MB L2);
  a call that waits on the device within itself is timed from two
  profiles instead (``WAITING_CALLS``);
* :func:`device_profile`: the profiler's kernel rows of a run, held against
  the run's CUDA-event span, because ``torch.profiler`` on the H100 now and
  then loses a stretch of kernel records (``PROFILE_MISSES``).

No profiler is involved unless a call waits on the device or a profile is
asked for.
"""

from __future__ import annotations

import time

import torch

__all__ = ["CYCLES_PER_MS", "PROFILE_MISSES", "WAITING_CALLS", "events_ms",
           "profiled", "kernel_ms", "device_profile", "measure"]

CYCLES_PER_MS = 2.0e6  # the H100's top SM clock; at a lower clock a sleep lasts longer
PROFILE_MISSES = []  # every profile taken again: records lost, or the host outran its sleep
PROFILE_TRIES = 5  # the losses come in stretches of a few sessions: pause, retry
WAITING_CALLS = []  # timed functions that wait on the device within a call


def events_ms(run, sleep_ms=0.0):
    """``(span ms, host ms)``: the span between CUDA events recorded around
    ``run()``, and the host's time to issue it.  With ``sleep_ms`` a sleep
    kernel holds the stream first; while the host issues the run before the
    sleep ends, the run's kernels then go back to back and the span is their
    device time with the device's own gaps between kernels and no host gap.
    No profiler is involved."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    if sleep_ms:
        torch.cuda._sleep(int(sleep_ms * CYCLES_PER_MS))
    s = time.perf_counter()
    e0.record()
    run()
    e1.record()
    host_ms = 1e3 * (time.perf_counter() - s)
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), host_ms


def profiled(run, sleep_ms=0.0, host=False):
    """``(kernel rows, span ms)`` of one ``run()`` under the profiler (CUDA
    activity only): the ``key_averages`` rows of the kernels the run
    launched, less the sleep kernel and torch.optim's ``Optimizer.*``
    annotation (it spans kernels counted already), and the CUDA-event span
    of the run (:func:`events_ms`); ``host`` adds the host's ms to issue
    the run under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        span, host_ms = events_ms(run, sleep_ms)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("Optimizer.") and "spin_kernel" not in e.key]
    return (rows, span, host_ms) if host else (rows, span)


def kernel_ms(rows):
    """The device ms of profiler rows."""
    return sum(e.self_device_time_total for e in rows) / 1e3


def _lost(what, why, **kw):
    PROFILE_MISSES.append({"what": what, "why": why, **kw})
    print(f"[profile] {why}: {PROFILE_MISSES[-1]}; profiling again in a second",
          flush=True)
    time.sleep(1.0)


def device_profile(run, what, sleep_ms):
    """``(kernel rows, span ms)`` of one ``run()`` issued behind a
    ``sleep_ms`` sleep kernel under the profiler.  The rows' device time is
    held against the span of the same run: below half of it, the loss is
    logged, recorded in ``PROFILE_MISSES`` and the run profiled again a
    second later (a loss spans a few sessions in a row); the
    ``PROFILE_TRIES``-th loss fails.  A span is that reference only when
    the host issued the whole run before the sleep ended: where the
    profiled host took longer, the span holds the host's gaps, and the run
    is profiled again behind twice that host time."""
    for _ in range(PROFILE_TRIES):
        rows, span, host_ms = profiled(run, sleep_ms, host=True)
        if kernel_ms(rows) >= 0.5 * span:
            return rows, span
        if host_ms > sleep_ms:
            _lost(what, "the host outran the sleep", device_ms=kernel_ms(rows),
                  span_ms=span, host_ms=host_ms, sleep_ms=sleep_ms)
            sleep_ms = 2 * host_ms + 5
            continue
        _lost(what, "kernel records lost", device_ms=kernel_ms(rows), span_ms=span)
    raise AssertionError(f"the profiler lost kernel records of {what} "
                         f"{PROFILE_TRIES} times")


def measure(fn, arg_sets, reps=40):
    """(device ms, call ms) per call, cycling through ``arg_sets`` (copies of
    the inputs, so the working set exceeds the 50 MB L2).  Call ms: CUDA
    events around back-to-back calls, which include the host's time to
    issue each call whenever the host is the slower.  Device ms: the same
    calls issued behind a sleep kernel three times as long as that, so they
    run back to back on the device.  A call that waits on the device itself
    (recorded in ``WAITING_CALLS``) cannot get ahead of the sleep; its
    device ms is the larger kernel time of two profiles (a lost stretch of
    records only lowers a reading) that agree within 20%; a pair that does
    not is recorded in ``PROFILE_MISSES`` and taken again a second later,
    the ``PROFILE_TRIES``-th fails."""
    def run():
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])

    for a in arg_sets[:3]:
        fn(*a)
    call_ms, _ = events_ms(run)
    sleep_ms = 3 * call_ms + 5
    dev_ms, host_ms = events_ms(run, sleep_ms)
    if host_ms < 0.8 * sleep_ms:
        return dev_ms / reps, call_ms / reps
    what = getattr(fn, "__qualname__", str(fn))
    WAITING_CALLS.append(what)
    for _ in range(PROFILE_TRIES):
        a, b = (kernel_ms(profiled(run)[0]) for _ in range(2))
        if min(a, b) >= 0.8 * max(a, b) > 0:
            return max(a, b) / reps, call_ms / reps
        _lost(what, "profiles disagree", device_ms=[a, b])
    raise AssertionError(f"the profiler lost kernel records of {what} "
                         f"{PROFILE_TRIES} times")
