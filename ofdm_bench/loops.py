"""The two loops that drive a cell's window, and their arithmetic.

A closed loop runs steps back to back for the window's length and ends in
a synchronize: work over wall time.  An open loop makes step j due at
t0 + j / rate, whether or not the steps before it have finished, and times
each step from its due time to the moment its outputs are complete on the
device: a CUDA event recorded after the step, read against an event
recorded at t0 (``DeviceClock``), so that no step waits for the host.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np


class Reservoir:
    """A uniform sample of the steps offered, drawn by ``rng`` (Algorithm
    R), stratified by step index mod ``strata``: ``ceil(k / strata)`` steps
    of each stratum, so that every stratum (a link cell's SNR point) is
    checked.  The outputs a check reads once the window has closed, without
    holding every step's outputs through it."""

    def __init__(self, k: int, rng: np.random.Generator, strata: int = 1):
        self.rng, self.strata = rng, strata
        self.per = -(-k // strata)
        self.seen = [0] * strata
        self.slots: list = [[] for _ in range(strata)]

    def offer(self, index: int, out) -> None:
        s = index % self.strata
        items = self.slots[s]
        if len(items) < self.per:
            items.append((index, out))
        else:
            j = int(self.rng.integers(0, self.seen[s] + 1))
            if j < self.per:
                items[j] = (index, out)
        self.seen[s] += 1

    @property
    def items(self) -> list:
        return [item for slot in self.slots for item in slot]


class DeviceClock:
    """Completion times of steps on the device, on the host's clock."""

    def __init__(self, torch):
        self.torch = torch

    def sync(self) -> None:
        self.torch.cuda.synchronize()

    def events(self, n: int) -> list:
        return [self.torch.cuda.Event(enable_timing=True) for _ in range(n)]

    def anchor(self) -> float:
        """Record the reference event on an idle device; its host time."""
        self.sync()
        self._anchor = self.torch.cuda.Event(enable_timing=True)
        self._anchor.record()
        self._anchor.synchronize()
        return time.perf_counter()

    def mark(self, event) -> None:
        event.record()

    def done(self, t0: float, events: list) -> np.ndarray:
        self.sync()
        return t0 + np.array([self._anchor.elapsed_time(e) for e in events]
                             ) / 1e3


class HostClock:
    """The same on a device that runs in the host's order (the CPU)."""

    def sync(self) -> None:
        pass

    def events(self, n: int) -> list:
        return [None] * n

    def anchor(self) -> float:
        self._marks = []
        return time.perf_counter()

    def mark(self, event) -> None:
        self._marks.append(time.perf_counter())

    def done(self, t0: float, events: list) -> np.ndarray:
        return np.array(self._marks)


def closed_loop(step, first: int, seconds: float, clock, keep: Reservoir,
                span=None):
    """Steps first, first + 1, ... back to back until ``seconds`` have
    passed, then a synchronize.  Returns (steps, wall seconds, the host
    time each step was enqueued by)."""
    clock.sync()
    t0 = time.perf_counter()
    i = first
    marks = []
    while marks == [] or marks[-1] - t0 < seconds:
        with span("harness.step") if span else nullcontext():
            keep.offer(i, step(i))
        marks.append(time.perf_counter())
        i += 1
    clock.sync()
    return i - first, time.perf_counter() - t0, np.asarray(marks) - t0


def wait_until(t: float) -> None:
    """Sleep to within half a millisecond of t, then spin to it."""
    dt = t - time.perf_counter() - 5e-4
    if dt > 0:
        time.sleep(dt)
    while time.perf_counter() < t:
        pass


def open_loop(step, first: int, n_steps: int, rate: float, clock,
              keep: Reservoir, span=None):
    """Step first + j due at t0 + j / rate for j < n_steps.  Returns (due,
    started, done), host seconds of each step: when it was due, when the
    host began it (late where the step before ran past its due time), when
    its outputs were complete on the device."""
    events = clock.events(n_steps)
    t0 = clock.anchor()
    due = t0 + np.arange(n_steps) / rate
    started = np.empty(n_steps)
    for j in range(n_steps):
        with span("harness.wait_due") if span else nullcontext():
            wait_until(due[j])
        started[j] = time.perf_counter()
        with span("harness.step") if span else nullcontext():
            keep.offer(first + j, step(first + j))
        clock.mark(events[j])
    return due, started, clock.done(t0, events)


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the order statistics (numpy's
    default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def backlog_max(due: np.ndarray, done: np.ndarray) -> int:
    """The most steps past due and not yet complete at any one time: steps
    with due <= t < done, over every t."""
    times = np.concatenate([done, due])
    delta = np.concatenate([-np.ones(len(done)), np.ones(len(due))])
    order = np.lexsort((delta, times))      # at a tie, completions first
    return int(np.cumsum(delta[order]).max(initial=0))
