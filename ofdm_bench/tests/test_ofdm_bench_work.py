"""K4's bytes and operations at the four cells' shapes, against hand
counts, and the shapes the entries hand the metric."""

from __future__ import annotations

import json
import math
import pathlib

import pytest
import torch

from ofdm_bench import harness
from ofdm_bench.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S

k4 = vars(harness.metric_module("k4_roofline.link"))

# (cell, B, samples a row K4 reads, trials, nfft, cp): GOLDEN64 frames are
# 240 x 80 + 63 samples with trials at every sample but the last
# 80 + 64 + 16; LTE2048 frames 64 x 2560 + 2047 with trials every 511; a
# live step reads the history (GOLDEN64 320, LTE2048 21 strides of 511)
# and the chunk, whose every stride is a trial.
HAND = [
    ("g64-link", 512, 19263, 19103, 64, 16),
    ("l2k-link", 32, 165887, 315, 2048, 512),
    ("g64-live", 16, 320 + 65520, 65520, 64, 16),
    ("l2k-live", 16, 21 * 511 + 130816, 256, 2048, 512),
]


@pytest.mark.parametrize("cell,b,n,trials,nfft,cp", HAND)
def test_k4_counts_by_hand(cell, b, n, trials, nfft, cp):
    shape = dict(batch=b, n=n, n_trials=trials, nfft=nfft, cp=cp, m_synch=1)
    log2 = int(math.log2(nfft))
    # one forward and one inverse transform of nfft points, and 12
    # operations a bin for the power and the multiply-add with conj(ZC)
    per_trial = 2 * 5 * nfft * log2 + 12 * nfft
    assert k4["k4_ops"](**shape) == b * trials * per_trial
    # complex64 samples in, float32 |corr| of cp + 1 delays out
    assert k4["k4_bytes"](**shape) == b * n * 8 + b * trials * (cp + 1) * 4
    least = max(k4["k4_bytes"](**shape) / HBM_BYTES_PER_S,
                b * trials * per_trial / FP32_OPS_PER_S)
    assert k4["k4_least_s"](shape) == pytest.approx(least, rel=1e-12)


def test_g64_link_least_time_is_the_bring_up_bound():
    """PERF.md's K4 G64 b128 row: 0.1684 ms, bound by operations."""
    shape = dict(batch=128, n=19263, n_trials=19103, nfft=64, cp=16,
                 m_synch=1)
    assert k4["k4_least_s"](shape) * 1e3 == pytest.approx(0.1684, abs=5e-5)


@pytest.mark.parametrize("cell,b,n,trials,nfft,cp", HAND)
def test_entries_hand_k4_its_shape(cell, b, n, trials, nfft, cp):
    spec = harness.cell_spec(cell)
    mod = __import__(f"ofdm_bench.entries.{spec['traffic']['entry']}",
                     fromlist=["Entry"])
    entry = mod.Entry(spec["config"], spec["traffic"], torch.device("cpu"))
    assert entry.k4_shape() == dict(batch=b, n=n, n_trials=trials,
                                    nfft=nfft, cp=cp, m_synch=1)


def test_roofline_reader_reads_the_sync_search_kernels_only():
    shape = dict(batch=128, n=19263, n_trials=19103, nfft=64, cp=16,
                 m_synch=1)
    least = k4["k4_least_s"](shape)
    trace = {"steps": 2, "device": [
        ("(anonymous namespace)::sync_search_direct_kernel(float2 const*)",
         0.0, 2 * least * 1e6),
        ("(anonymous namespace)::sync_search_direct_kernel(float2 const*)",
         10.0, 10.0 + 2 * least * 1e6),
        ("void at::native::reduce_kernel<512>", 0.0, 500.0)]}
    assert harness.metric_module("k4_roofline.link").read(
        {"trace": trace, "k4": shape}) == pytest.approx(50.0)
    # a step in which no kernel of that name ran leaves the metric silent
    trace["device"] = trace["device"][2:]
    assert harness.metric_module("k4_roofline.live").read(
        {"trace": trace, "k4": shape}) is None
    ops = harness.metric_module("ops_device_ms.link").read(
        {"trace": trace, "k4": shape})
    assert ops == pytest.approx(0.25)


def test_every_per_layer_metric_has_a_reader():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        assert callable(harness.metric_module(m["name"]).read)
    for w in spec["workloads"]:
        for sub, key in (("configs", "config"), ("traffic", "traffic")):
            assert (harness.BENCH / sub / f"{w[key]}.json").exists()
        assert (harness.BENCH / "cells" / f"{w['name']}.json").exists()
    assert pathlib.Path(harness.BENCH / "run.py").exists()


def test_breakdown_names_idle_gaps_by_the_innermost_host_span():
    from ofdm_bench import devtrace
    tr = {"steps": 2, "window_s": 0.001, "device": [
        ("k_a", 0.0, 100.0), ("k_b", 50.0, 150.0), ("k_a", 400.0, 450.0),
        ("k_c", 460.0, 470.0), ("k_a", 900.0, 950.0)],
        "host": [("harness.step", 0.0, 300.0), ("aten::cat", 200.0, 300.0),
                 ("harness.wait_due", 300.0, 880.0),
                 ("aten::sum", 440.0, 470.0),
                 ("harness.step", 880.0, 920.0)]}
    assert devtrace.busy_intervals(tr["device"]) == [[0.0, 150.0],
                                                     [400.0, 450.0],
                                                     [460.0, 470.0],
                                                     [900.0, 950.0]]
    assert devtrace.busy_s(tr["device"]) == pytest.approx(260e-6)
    # a step's span runs to its last device operation, and the wait for
    # the next due time lies outside every span
    assert devtrace.step_spans(tr) == [[0.0, 470.0], [880.0, 950.0]]
    b = devtrace.breakdown(tr)
    assert b["device_ops"][0] == ["k_a", pytest.approx(200e-6)]
    assert b["idle_gaps"] == [["aten::cat", pytest.approx(250e-6)],
                              ["harness.step", pytest.approx(20e-6)],
                              ["aten::sum", pytest.approx(10e-6)]]
    idle = harness.metric_module("idle_share.live").read({"trace": tr})
    assert idle == pytest.approx(100 * (1 - 260 / 540))
    assert harness.metric_module("launches.link").read({"trace": tr}) == 2.5


def test_idle_share_of_back_to_back_steps_is_the_whole_window_s():
    """Closed loop: each step's host span reaches the next's start, so the
    spans merge into one from the first step to the last device work."""
    from ofdm_bench import devtrace
    tr = {"steps": 3, "device": [("k", 10.0, 40.0), ("k", 60.0, 90.0),
                                  ("k", 110.0, 160.0)],
          "host": [("harness.step", 0.0, 50.0), ("harness.step", 50.0, 100.0),
                   ("harness.step", 100.0, 120.0)]}
    assert devtrace.step_spans(tr) == [[0.0, 160.0]]
    idle = harness.metric_module("idle_share.link").read({"trace": tr})
    assert idle == pytest.approx(100 * (1 - 110 / 160))
    assert harness.metric_module("idle_share.link").read(
        {"trace": dict(tr, host=[])}) is None


def test_window_readers_read_the_window():
    win = {"live_p95_ms": 7.5, "backlog_max": 3}
    assert harness.metric_module("live_p95_ms").read({"window": win}) == 7.5
    assert harness.metric_module("live_backlog_max").read(
        {"window": win}) == 3
