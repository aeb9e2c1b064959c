"""The check of ``correct``, driven through the rest of a run on the CPU at
a tiny size (the look for a card skipped): it holds on the program as it
is, and comes out false with the control in the program's place and with
each fault a cell can have planted in the timed path.  (No cell spans
chips, so there is no exchange between chips to leave out.)"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from ofdm_bench import harness

LINK = ("g64-link", {"frames": 4, "pool_steps": 2, "snr_db": [6, 24]})
LIVE = ("g64-live", {"streams": 4, "chunk": 1920, "rate_hz": 8.0,
                     "ring_frames": 2})
LIVE_L2K = ("l2k-live", {"streams": 2, "rate_hz": 2.0, "ring_frames": 1})


def measure(cell, overrides, seconds=0.6, control=False, seed=2 ** 31 + 5):
    run = harness.Run(cell, "cpu", overrides=overrides)
    run.spec["check"] = dict(run.spec["check"], check_steps=2,
                             check_answers=4)
    return run, harness.measure(run, seed, seconds, False, None, control)


@pytest.mark.parametrize("cell,overrides", [LINK, LIVE, LIVE_L2K],
                         ids=["link", "live", "live-l2k"])
def test_program_as_it_is_is_correct(cell, overrides):
    run, m = measure(cell, overrides, seconds=1.0 if cell == "l2k-live"
                     else 0.6)
    assert m["tally"].checked >= 2 and m["tally"].correct, m["tally"].lines()
    assert m["attempted"] == m["win"]["steps"] * run.entry.answers_per_step


@pytest.mark.parametrize("cell,overrides", [LINK, LIVE], ids=["link",
                                                                "live"])
def test_control_in_the_programs_place_is_not_correct(cell, overrides):
    _, m = measure(cell, overrides, control=True)
    assert not m["tally"].correct
    lines = m["tally"].lines()
    assert lines["phasor_gap"]["value"] > 3 * lines["phasor_gap"]["limit"]


def _altered_chain(chain, how):
    real = chain.chain_batch

    def broken(*a, **k):
        r = real(*a, **k)
        if how == "answer":           # one bit of each frame flipped
            bits = r.hard_bits.clone()
            bits[:, 7] ^= 1
            return r._replace(hard_bits=bits)
        # half of the batch left out: its frames carry the other half's
        half = r.ber.shape[0] // 2
        return type(r)(*(torch.cat([f[:half], f[:half]]) for f in r))
    return broken


@pytest.mark.parametrize("how", ["answer", "half_batch"])
def test_link_faults_are_not_correct(monkeypatch, how):
    from lte_gnu_radio_code_tpu_torch.models import chain
    monkeypatch.setattr(chain, "chain_batch", _altered_chain(chain, how))
    _, m = measure(*LINK)
    assert not m["tally"].correct


@pytest.mark.parametrize("how", ["state", "half_batch", "answer"])
def test_live_faults_are_not_correct(monkeypatch, how):
    from lte_gnu_radio_code_tpu_torch.runtime import stream
    real = stream.reacq_step

    def broken(cfg, state, chunk, *a, **k):
        new, out = real(cfg, state, chunk, *a, **k)
        if how == "state":            # the step returns its state unchanged
            return state, out
        if how == "answer":           # one bit of every slot flipped
            bits = out.hard_bits.clone()
            bits[..., 0, 3] ^= 1
            return new, out._replace(hard_bits=bits)
        half = chunk.shape[0] // 2    # streams of the second half left out
        return new, type(out)(*(torch.cat([f[:half], f[:half]])
                                for f in out))
    monkeypatch.setattr(stream, "reacq_step", broken)
    _, m = measure(*LIVE)
    assert not m["tally"].correct


def test_result_line_keys_and_order():
    run, m = measure(*LINK)
    line = harness.result_line(run, m, False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"link_msamples_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {"wrong_decisions", "wrong_bits",
                                   "phasor_gap"}
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    json.dumps(line)


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types
    assert harness.forbidden_modules() == [] or all(
        m.split(".")[0] in harness.FORBIDDEN
        for m in harness.forbidden_modules())
    for name in ("jaxtyping", "lte_gnu_radio_code_tpu_torch.fake", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not set(harness.forbidden_modules()) & {
        "jaxtyping", "lte_gnu_radio_code_tpu_torch.fake", "flaxen"}
    monkeypatch.setitem(sys.modules, "lte_gnu_radio_code_tpu.models",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert {"lte_gnu_radio_code_tpu.models", "jax"} <= set(
        harness.forbidden_modules())


def test_run_without_a_card_fails_and_prints_no_result(tmp_path):
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    r = subprocess.run([sys.executable, str(harness.BENCH / "run.py"),
                        "--workload", "g64-link", "--seed", "3",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env,
                       cwd=str(harness.ROOT), timeout=300)
    assert r.returncode != 0
    assert not [l for l in r.stdout.splitlines() if l.startswith("{")]


def test_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "ofdm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "ofdm_bench/run.py", "--workload",
                        "g64-link", "--seed", "3", "--seconds", "1"],
                       capture_output=True, text=True, cwd=str(tmp_path),
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
                       timeout=300)
    assert r.returncode != 0
    assert not [l for l in r.stdout.splitlines() if l.startswith("{")]


def test_a_cell_mix_config_and_metric_are_added_as_files(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric reader and a cell by new files and one new entry alone, and the
    harness runs the new cell and finds the new reader by name."""
    shutil.copytree(harness.BENCH, tmp_path / "ofdm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "g64s-tiny", "config": "golden64s",
                              "traffic": "link_b3", "chips": 1,
                              "why": "a throwaway cell"})
    spec["per_layer"].append({
        "name": "throwaway_steps.link", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "chain step",
        "moves": "link_msamples_s", "workloads": ["g64s-tiny"]})
    for m in spec["end_to_end"]:
        if m["name"] == "link_msamples_s":
            m["workloads"].append("g64s-tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    b = tmp_path / "ofdm_bench"
    cfg = json.loads((b / "configs" / "golden64.json").read_text())
    cfg["num_ofdm_symb"] = 16
    (b / "configs" / "golden64s.json").write_text(json.dumps(cfg))
    (b / "traffic" / "link_b3.json").write_text(json.dumps(
        {"entry": "chain", "frames": 3, "pool_steps": 2, "snr_db": [12]}))
    (b / "cells" / "g64s-tiny.json").write_text(
        (b / "cells" / "g64-link.json").read_text())
    (b / "metrics" / "throwaway_steps.py").write_text(
        "def read(ctx):\n    return float(ctx['trace']['steps'])\n")
    code = f"""
import sys
sys.path.insert(0, {str(tmp_path)!r}); sys.path.insert(1, {str(harness.ROOT)!r})
from ofdm_bench import harness
assert harness.BENCH.parent == __import__('pathlib').Path({str(tmp_path)!r})
run = harness.Run("g64s-tiny", "cpu")
m = harness.measure(run, 11, 0.3, False)
assert m["tally"].correct and m["tally"].checked, m["tally"].lines()
assert [x["name"] for x in run.spec["per_layer"]] == ["throwaway_steps.link"]
read = harness.metric_module("throwaway_steps.link").read
assert read({{"trace": {{"steps": 40}}}}) == 40.0
print("ok", m["e2e"]["link_msamples_s"]["value"] > 0)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(tmp_path), timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok True")


def test_check_covers_every_stream_and_snr_point():
    """The kept steps' answers are dealt from one permutation: 4 steps of
    4 streams cover all 16 streams; a link sample keeps each SNR point."""
    import numpy as np
    from ofdm_bench import loops

    class Entry:
        answers_per_step = 16
        strata = 1

        def __init__(self):
            self.seen = []

        def answers(self, i, out, picks):
            self.seen += [(i, int(p)) for p in picks]
            return []

    run = object.__new__(harness.Run)
    run.entry = Entry()
    run.spec = {"check": {"check_steps": 4, "check_answers": 4,
                          "tie_share_of_gate": 0.001, "limits": {"x": 0}}}
    keep = loops.Reservoir(4, np.random.default_rng(0))
    for i in range(100):
        keep.offer(i, None)
    run.check(keep, seed=2 ** 33 + 1)
    assert sorted(p for _, p in run.entry.seen) == list(range(16))
    assert len({i for i, _ in run.entry.seen}) == 4

    link = harness.Run(LINK[0], "cpu", overrides=dict(
        LINK[1], snr_db=[6, 12, 24]))
    assert link.entry.strata == 3
