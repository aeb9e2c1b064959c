"""The readers of the program's stage spans and counters
(``ofdm_bench/stages.py`` and its metrics), on synthetic traces."""

from __future__ import annotations

import json

import pytest
import torch

from ofdm_bench import harness, stages
from lte_gnu_radio_code_tpu_torch.utils import profiling


def launch(t):
    return ("cudaLaunchKernel", t, t + 1)


# two chain steps (us): root [0, 100] with ofdm.tx [5, 30] and ofdm.lock
# [40, 90]; root [200, 300] with ofdm.tx [205, 220] and ofdm.lock [230,
# 280]; one launch call in each tx, two in each lock, one in each root
# outside its stages and one outside every span, each paired in order
# with one device operation
HOST = [
    ("harness.step", 0, 100), ("ofdm.chain_step", 0, 100),
    ("ofdm.tx", 5, 30), ("ofdm.lock", 40, 90),
    ("harness.step", 200, 300), ("ofdm.chain_step", 200, 300),
    ("ofdm.tx", 205, 220), ("ofdm.lock", 230, 280),
    ("aten::amax", 44, 47),
] + [launch(t) for t in (10, 45, 50, 95, 150, 210, 240, 250, 290)]
DEVICE = [("k1", 20, 25), ("amax", 60, 70), ("argmax", 70, 85),
          ("ber", 100, 110), ("copy", 150, 152), ("k1", 215, 225),
          ("amax", 260, 275), ("argmax", 275, 290), ("ber", 300, 305)]


def trace(host=HOST, device=DEVICE):
    calls = sum(bool(stages.LAUNCH_CALL.match(n)) for n, _, _ in host)
    return dict(host=list(host), device=list(device), launch_calls=calls,
                steps=2, window_s=1e-3)


def test_stage_time_per_root_span_and_its_median():
    tr = trace()
    assert stages.stage_ms(tr, "ofdm.tx") == pytest.approx([0.025, 0.015])
    assert stages.median_stage_ms(tr, "ofdm.tx") == pytest.approx(0.020)
    assert stages.median_stage_ms(tr, "ofdm.lock") == pytest.approx(0.050)
    assert stages.median_stage_ms(tr, "ofdm.demap") is None
    # each root's own time: 100 - 25 - 50 and 100 - 15 - 50 us
    assert stages.root_self_ms(tr) == pytest.approx([0.025, 0.035])


def test_device_operations_go_to_the_innermost_span_of_their_launch():
    tr = trace()
    pairs, steps = stages.attributed(tr)
    assert steps == 2
    assert [(op[0], o) for op, o in pairs] == [
        ("k1", "ofdm.tx"), ("amax", "ofdm.lock"), ("argmax", "ofdm.lock"),
        ("ber", "ofdm.chain_step"), ("copy", None), ("k1", "ofdm.tx"),
        ("amax", "ofdm.lock"), ("argmax", "ofdm.lock"),
        ("ber", "ofdm.chain_step")]
    # (10 + 15) + (15 + 15) us over two steps
    assert stages.device_ms(tr, "ofdm.lock") == pytest.approx(0.0275)
    assert stages.launches(tr, "ofdm.lock") == 2
    assert stages.launches(tr, "ofdm.tx") == 1
    assert stages.launches(tr, "ofdm.demap") == 0


def test_innermost_of_nested_and_sibling_spans():
    spans = stages.program_spans(dict(host=[
        ("ofdm.a", 0, 10), ("ofdm.b", 2, 4), ("ofdm.c", 5, 7),
        ("ofdm.d", 5, 6)]))
    assert stages.innermost(spans, [-1, 0, 3, 4, 5, 6, 7, 10]) == [
        None, "ofdm.a", "ofdm.b", "ofdm.a", "ofdm.d", "ofdm.c", "ofdm.a",
        None]


def steps_trace(n, drop=()):
    """n identical chunk steps 1000 us apart, each with two launches in
    ofdm.select and one in ofdm.demod; the device operations at the
    indices ``drop`` lost."""
    host, device = [], []
    for i in range(n):
        b = 1000 * i
        host += [("ofdm.chunk_step", b, b + 100), ("ofdm.select", b + 10,
                                                   b + 60),
                 ("ofdm.demod", b + 60, b + 90)]
        host += [launch(b + t) for t in (20, 30, 70)]
        device += [("cummin", b + 40, b + 50), ("where", b + 50, b + 55),
                   ("gemm", b + 75, b + 95)]
    device = [op for k, op in enumerate(device) if k not in drop]
    return dict(host=host, device=device, launch_calls=3 * n, steps=n)


def test_a_lost_device_event_leaves_its_step_out():
    whole = steps_trace(4)
    assert stages.device_ms(whole, "ofdm.select") == pytest.approx(0.015)
    # the second step's "where" lost: the first step pairs in place, the
    # third and fourth one operation back, and the second is left out
    tr = steps_trace(4, drop={4})
    pairs, steps = stages.attributed(tr)
    assert steps == 3 and len(pairs) == 9
    assert stages.device_ms(tr, "ofdm.select") == pytest.approx(0.015)
    assert stages.device_ms(tr, "ofdm.demod") == pytest.approx(0.020)
    assert stages.launches(tr, "ofdm.select") == 2


@pytest.mark.parametrize("tr", [
    steps_trace(4, drop={1, 4}),                  # two lost
    steps_trace(4, drop={0}),                     # first or last step?
    steps_trace(1, drop={1}),                     # no other step
    dict(steps_trace(2), device=steps_trace(2)["device"] * 2),  # too many
], ids=["two-lost", "at-an-end", "one-step", "more-ops-than-calls"])
def test_no_attribution_where_the_steps_cannot_be_found(tr):
    assert stages.attributed(tr) is None
    assert stages.device_ms(tr, "ofdm.select") is None
    assert stages.launches(tr, "ofdm.select") == 2


def test_a_lost_event_that_two_steps_could_hold_is_not_placed():
    """Steps whose operations all bear one name: the lost one could be in
    any step, so no step is found."""
    tr = steps_trace(3, drop={4})
    tr["device"] = [("k", s, e) for _, s, e in tr["device"]]
    assert stages.attributed(tr) is None


def test_idle_time_and_gaps_by_stage():
    tr = trace()
    # idle inside the steps' spans [0, 152] and [200, 305], split where a
    # span opens or closes, over two steps
    got = stages.idle_ms(tr)
    assert got == pytest.approx({"ofdm.chain_step": 0.0225,
                                 "ofdm.tx": 0.015, "ofdm.lock": 0.0275,
                                 None: 0.020})
    gaps = stages.gap_owners(tr, top=3)
    assert [d for _, d in gaps] == pytest.approx([0.040, 0.035, 0.035])
    assert [o for o, _ in gaps] == [None, "ofdm.lock", "ofdm.lock"]
    s = stages.summary(tr)
    assert s["steps"] == 2 and s["gaps_in_spans"] == 6
    assert s["root_self_ms"] == pytest.approx(0.030)
    assert s["stages"]["ofdm.lock"]["launches"] == 2


def test_occupancy_ratio():
    assert stages.occupancy({"ofdm.detections": (30, 3),
                             "ofdm.slots": (120, 3)}) == 25.0
    assert stages.occupancy({"ofdm.slots": (120, 3)}) == 0.0
    assert stages.occupancy({}) is None
    assert stages.occupancy(None) is None
    assert stages.occupancy({"ofdm.slots": (0, 0)}) is None


STAGE_METRICS = [
    "tx_host_ms.link", "search_host_ms.link", "lock_host_ms.link",
    "demod_host_ms.link", "demap_host_ms.link", "search_host_ms.live",
    "select_host_ms.live", "demod_host_ms.live", "decide_host_ms.live",
    "lock_device_ms.link", "demod_device_ms.live", "select_launches.live"]


def test_the_benchmark_lists_every_stage_metric():
    listed = {m["name"]: m for m in json.loads(
        (harness.ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    for name in STAGE_METRICS + ["slot_occupancy.live"]:
        m = listed[name]
        live = name.endswith(".live")
        assert m["layer"] == ("chunk step" if live else "chain step")
        assert m["moves"] == ("live_p50_ms" if live else "link_msamples_s")
        assert m["workloads"] == (["l2k-live", "g64-live"] if live
                                  else ["g64-link", "l2k-link"])


def one_step(root, names, calls, device):
    """One step of 100 us: its stages 20 us each in turn from 0."""
    host = [(root, 0, 100)] + [(n, 20 * i, 20 * (i + 1))
                               for i, n in enumerate(names)]
    return dict(host=host + [launch(t) for t in calls], device=device,
                launch_calls=len(calls), steps=1)


def test_every_stage_metric_reads_its_span():
    link = one_step("ofdm.chain_step", ["ofdm.tx", "ofdm.search",
                                        "ofdm.lock", "ofdm.demod",
                                        "ofdm.demap"],
                    [45, 50], [("amax", 50, 62), ("argmax", 62, 70)])
    live = one_step("ofdm.chunk_step", ["ofdm.search", "ofdm.select",
                                        "ofdm.demod", "ofdm.decide"],
                    [30, 35, 50], [("cummin", 35, 45), ("max", 45, 50),
                                   ("gemm", 55, 75)])
    read = {n: harness.metric_module(n).read(
        {"trace": live if n.endswith(".live") else link})
        for n in STAGE_METRICS}
    assert read == pytest.approx({
        **{n: 0.020 for n in STAGE_METRICS if "_host_ms" in n},
        "lock_device_ms.link": 0.020, "demod_device_ms.live": 0.020,
        "select_launches.live": 2})


@pytest.mark.parametrize("name", STAGE_METRICS + ["slot_occupancy.live"])
def test_a_program_without_spans_or_counters_reads_nothing(name,
                                                           monkeypatch):
    parent = [x for x in HOST if not x[0].startswith("ofdm.")]
    monkeypatch.delattr(profiling, "counters")
    assert harness.metric_module(name).read(
        {"trace": trace(host=parent)}) is None


def test_slot_occupancy_reads_the_programs_counters():
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for found in ([3, 1], [0, 2]):
            profiling.count("ofdm.detections", torch.tensor(found))
            profiling.count("ofdm.slots", 2 * 8)
    try:
        assert harness.metric_module("slot_occupancy.live").read({}) == \
            pytest.approx(100 * 6 / 32)
    finally:
        profiling.reset_counters()
