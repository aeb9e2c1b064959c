"""The open-loop scheduler's due-time latency, backlog and percentile
arithmetic, on a fake clock with a step that stalls once; the reservoir."""

from __future__ import annotations

import numpy as np
import pytest

from ofdm_bench import loops


class FakeTime:
    """A host clock that moves only when the code under test sleeps, steps
    or reads it (by a microsecond a read, so that a spin ends)."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        self.now += 1e-6
        return self.now

    def sleep(self, dt):
        self.now += dt


@pytest.fixture
def fake(monkeypatch):
    t = FakeTime()
    monkeypatch.setattr(loops.time, "perf_counter", t.perf_counter)
    monkeypatch.setattr(loops.time, "sleep", t.sleep)
    return t


def run_open(fake, n=20, rate=100.0, stall_at=5, stall_s=0.051):
    """Steps of 1 ms each, one of ``stall_s``, due every 10 ms."""
    def step(i):
        fake.now += stall_s if i == stall_at else 0.001
        return i

    keep = loops.Reservoir(3, np.random.default_rng(0))
    due, started, done = loops.open_loop(step, 0, n, rate, loops.HostClock(),
                                         keep)
    return due, started, done, keep


def test_latency_runs_from_the_due_time(fake):
    due, started, done, _ = run_open(fake)
    lat = (done - due) * 1e3
    # on time: 1 ms a step (and the clock's microsecond reads)
    assert lat[:5] == pytest.approx(np.ones(5), abs=0.05)
    # the stall: 51 ms; the steps due behind it wait for it
    assert lat[5] == pytest.approx(51.0, abs=0.05)
    assert lat[6:11] == pytest.approx([42, 33, 24, 15, 6], abs=0.05)
    assert lat[11:] == pytest.approx(np.ones(9), abs=0.05)
    # the host began steps 6-10 late, by the stall's overhang
    late = (started - due) * 1e3
    assert late[6:11] == pytest.approx([41, 32, 23, 14, 5], abs=0.05)
    assert (late[11:] < 0.05).all()


def test_backlog_counts_the_steps_past_due_at_once(fake):
    due, _, done, _ = run_open(fake)
    # at 100 ms after the start steps 5..10 are due and none is done
    assert loops.backlog_max(due, done) == 6
    assert loops.backlog_max(np.array([0.0, 1.0]), np.array([0.5, 1.5])) == 1
    # a completion at the instant the next step is due frees its place
    assert loops.backlog_max(np.array([0.0, 1.0]), np.array([1.0, 2.0])) == 1
    assert loops.backlog_max(np.array([0.0, 0.0, 0.0]),
                             np.array([3.0, 2.0, 1.0])) == 3


def test_percentiles_of_every_step(fake):
    due, _, done, _ = run_open(fake)
    lat = (done - due) * 1e3
    srt = np.sort(lat)
    # linear between order statistics: p50 of 20 is the mean of the 10th
    # and 11th, p95 lies 0.05 of the way from the 19th to the 20th
    assert loops.percentile(lat, 50) == pytest.approx((srt[9] + srt[10]) / 2)
    assert loops.percentile(lat, 95) == pytest.approx(
        srt[18] + 0.05 * (srt[19] - srt[18]))


def test_closed_loop_counts_every_step_in_the_window(fake):
    def step(i):
        fake.now += 0.002
        return i

    keep = loops.Reservoir(2, np.random.default_rng(1))
    n, wall, marks = loops.closed_loop(step, 7, 1.0, loops.HostClock(), keep)
    assert n == pytest.approx(500, abs=1)
    assert wall == pytest.approx(1.0, abs=0.003)
    assert len(marks) == n and (np.diff(marks) > 0).all()
    assert len(keep.items) == 2
    assert all(7 <= i < 7 + n and out == i for i, out in keep.items)


def test_reservoir_is_uniform_and_seeded():
    counts = np.zeros(20)
    for s in range(2000):
        r = loops.Reservoir(4, np.random.default_rng(s))
        for i in range(20):
            r.offer(i, None)
        assert len(r.items) == 4 and len({i for i, _ in r.items}) == 4
        for i, _ in r.items:
            counts[i] += 1
    # each of 20 steps is kept with probability 4/20: 400 of 2000 draws
    assert np.abs(counts - 400).max() < 80
    a, b = (loops.Reservoir(3, np.random.default_rng(9)) for _ in range(2))
    for i in range(50):
        a.offer(i, None)
        b.offer(i, None)
    assert a.items == b.items


def test_reservoir_keeps_every_stratum():
    """A link cell's steps cycle its SNR points: the sample keeps
    ceil(k / strata) steps of each, drawn uniformly within it."""
    counts = np.zeros(40)
    for s in range(1000):
        r = loops.Reservoir(8, np.random.default_rng(s), strata=8)
        for i in range(3, 43):
            r.offer(i, None)
        kept = sorted(i for i, _ in r.items)
        assert sorted(i % 8 for i in kept) == list(range(8))
        for i in kept:
            counts[i - 3] += 1
    # each of a stratum's 5 steps is kept with probability 1/5
    assert np.abs(counts - 200).max() < 60
    r = loops.Reservoir(3, np.random.default_rng(0), strata=2)
    for i in range(10):
        r.offer(i, None)
    assert sorted(i % 2 for i, _ in r.items) == [0, 0, 1, 1]
