"""``graph_share.live`` (``metrics/graph_share.py``): the share of traced
chunk steps that replayed the receiver's CUDA graph, from the program's
counter ``ofdm.graph_steps``; on the CPU every step runs eagerly, so a
receiver there reads 0."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from ofdm_bench import harness
from lte_gnu_radio_code_tpu_torch.runtime import stream
from lte_gnu_radio_code_tpu_torch.utils import profiling
from lte_gnu_radio_code_tpu_torch.utils.params import GOLDEN64


def read():
    return harness.metric_module("graph_share.live").read({})


@pytest.fixture(autouse=True)
def empty_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.mark.parametrize("steps,share", [([1, 1, 1], 100.0),
                                         ([1, 0, 1, 1], 75.0),
                                         ([0, 0], 0.0)])
def test_graph_share_is_the_replayed_steps_share(steps, share):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for s in steps:
            profiling.count("ofdm.graph_steps", s)
            profiling.count("ofdm.slots", 8)
    assert read() == pytest.approx(share)


def test_a_program_without_the_counter_reads_nothing(monkeypatch):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("ofdm.slots", 8)
    assert read() is None
    monkeypatch.delattr(profiling, "counters")
    assert read() is None


def test_a_cpu_receiver_reads_no_replayed_step():
    rx = stream.BatchReacqStreamingRx(GOLDEN64, 960, 2, device="cpu")
    x = np.random.default_rng(1).standard_normal((3, 2, 960))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for c in x.astype(np.complex64):
            rx.push(c)
    assert read() == 0.0


def test_the_benchmark_lists_graph_share_for_the_reacq_cells():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    m = {x["name"]: x for x in spec["per_layer"]}["graph_share.live"]
    assert m == {"name": "graph_share.live", "unit": "%", "better": "higher",
                 "source": "program_counter", "layer": "chunk step",
                 "moves": "live_p50_ms",
                 "workloads": ["l2k-live", "g64-live", "l1k-live"]}
    cells = {w["name"]: w["traffic"] for w in spec["workloads"]}
    for cell in m["workloads"]:
        traffic = json.loads((harness.ROOT / "ofdm_bench" / "traffic" /
                              f"{cells[cell]}.json").read_text())
        assert traffic["entry"] == "reacq"
