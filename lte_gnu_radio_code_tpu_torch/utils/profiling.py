"""Tracing of the port's steps: stage spans and counters that cost a flag
read unless a ``torch.profiler`` session records.

- span: a named stage of a step.  While a profiler session records it is
  ``torch.profiler.record_function(name)``, a host annotation in the same
  trace as the kernels, so every idle gap of the device trace lies inside
  a named stage; otherwise one shared no-op context.  It adds no host
  sync, no device operation and no device allocation.
- count: a value a step has already computed (a host int, or a device
  tensor, never a reduction made for the counter), kept while a profiler
  session records; counters() sums them, reading device values only then,
  and kept() lists them.  A value that only a counter reads is computed
  under recording(), and so only then.
- trace: a ``torch.profiler`` trace of the block (CPU, and CUDA where
  present), written as a Chrome trace file into ``logdir`` (TensorBoard's
  profiler plugin reads it), the block's counters beside it.

The gate is torch's own flag, which a profiler session sets while it
records: tracing is on exactly then, with no setting of its own.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import socket
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
_counters: dict[str, list] = {}


def span(name: str):
    """The stage ``name`` as a context manager: a profiler annotation while
    a session records, else a shared no-op."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def recording() -> bool:
    """Whether a profiler session records, which turns spans and counters
    on: a step computes a value only a counter reads under this test."""
    return _autograd_profiler._is_profiler_enabled


def count(name: str, value) -> None:
    """Keep ``value`` (a host int or a device tensor the step has already
    computed) under ``name`` while a profiler session records."""
    if _autograd_profiler._is_profiler_enabled:
        _counters.setdefault(name, []).append(value)


def counters() -> dict[str, tuple[int, int]]:
    """{name: (total of every element of every value kept, values kept)};
    device values are read here, once a counter."""
    out = {}
    for name, values in _counters.items():
        total = sum(v for v in values if not torch.is_tensor(v))
        held = [v.reshape(-1).to(torch.int64) for v in values
                if torch.is_tensor(v)]
        if held:
            total += int(torch.cat([t.cpu() for t in held]).sum())
        out[name] = (int(total), len(values))
    return out


def kept(name: str) -> list:
    """The values kept under ``name``, in order, each on the host (a
    device tensor copied to the CPU)."""
    return [v.cpu() if torch.is_tensor(v) else v
            for v in _counters.get(name, [])]


def reset_counters() -> None:
    _counters.clear()


def _wait() -> None:
    """Wait for the CUDA device's queued work, where CUDA is in use."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir):
    """A torch.profiler trace of the block (CPU, and CUDA where present),
    written to ``logdir``/<host>.<pid>.<time ns>.pt.trace.json, and the
    block's counters to <host>.<pid>.<time ns>.counters.json beside it
    ({name: {"total": ..., "records": ...}})."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = pathlib.Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    reset_counters()
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            _wait()
    stem = path / f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}"
    prof.export_chrome_trace(f"{stem}.pt.trace.json")
    with open(f"{stem}.counters.json", "w") as f:
        json.dump({name: {"total": total, "records": records}
                   for name, (total, records) in counters().items()}, f,
                  indent=1)
