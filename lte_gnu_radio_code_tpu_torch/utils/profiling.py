"""Profiling and tracing helpers.

Port of ``lte_gnu_radio_code_tpu/utils/profiling.py``:

- simple_timeit: steady-state wall-clock of a callable, each call ended by
  a ``torch.cuda.synchronize`` where the JAX helper blocks on the result;
- trace: a ``torch.profiler`` trace of the block, written as a Chrome
  trace file into ``logdir`` (TensorBoard's profiler plugin reads it);
- stage_report: a per-stage timing table for a pipeline of callables.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import socket
import time

import torch


def _wait() -> None:
    """Wait for the CUDA device's queued work, where CUDA is in use."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def simple_timeit(fn, *args, min_seconds: float = 2.0, warmup: int = 3):
    """Returns (seconds_per_call, iters).  No host transfers in the loop."""
    for _ in range(warmup):
        fn(*args)
        _wait()
    iters, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < min_seconds or iters < 3:
        fn(*args)
        _wait()
        iters += 1
    return (time.perf_counter() - t0) / iters, iters


@contextlib.contextmanager
def trace(logdir):
    """A torch.profiler trace of the block (CPU, and CUDA where present),
    written to ``logdir``/<host>.<pid>.<time ns>.pt.trace.json."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = pathlib.Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            _wait()
    prof.export_chrome_trace(str(path / (
        f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}"
        ".pt.trace.json")))


def stage_report(stages: dict, *, min_seconds: float = 1.0) -> dict:
    """{name: (fn, args)} -> {name: seconds_per_call}; prints a table."""
    out = {}
    for name, (fn, args) in stages.items():
        dt, _ = simple_timeit(fn, *args, min_seconds=min_seconds)
        out[name] = dt
        print(f"{name:30s} {dt * 1e3:9.3f} ms")
    return out
