"""The 2x2 link cell (``l2k-2x2-link``, entry ``mimo_chain``) and
``l1k-link`` on the CPU at a tiny batch (the look for a card skipped): the
check holds on the program as it is and comes out false with the TF32
control in the program's place and with each fault planted in the timed
path; the frozen reference is the port's; the detection's roofline counts
by hand; the new readers read nothing from a program without their spans
and counter."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ofdm_bench import harness
from ofdm_bench.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S
from ofdm_bench.reference import mimo as frozen
from ofdm_bench.reference.numerology import RefConfig

MIMO = ("l2k-2x2-link", {"frames": 2, "pool_steps": 2, "snr_db": [6, 24]})
L1K = ("l1k-link", {"frames": 2, "pool_steps": 2, "snr_db": [6, 24]})
roof = vars(harness.metric_module("detect_roofline.link"))


def measure(cell, overrides, control=False, seed=2 ** 31 + 21):
    run = harness.Run(cell, "cpu", overrides=overrides)
    run.spec["check"] = dict(run.spec["check"], check_steps=2,
                             check_answers=2)
    return run, harness.measure(run, seed, 0.5, False, None, control)


@pytest.mark.parametrize("cell,overrides", [MIMO, L1K],
                         ids=["l2k-2x2", "l1k"])
def test_program_as_it_is_is_correct(cell, overrides):
    run, m = measure(cell, overrides)
    assert m["tally"].checked >= 2 and m["tally"].correct, m["tally"].lines()
    assert m["attempted"] == m["win"]["steps"] * run.entry.answers_per_step


def test_mimo_samples_a_step_are_both_rx_antennas():
    run = harness.Run(MIMO[0], "cpu", overrides=MIMO[1])
    e = run.entry
    assert e.samples_per_step == 2 * 2 * (e.base.frame_len + 2047)
    assert harness.cell_spec("l2k-2x2-link")["traffic"]["frames"] == 64
    assert e.base.num_bits == 115200 and e.n == 165887


@pytest.mark.parametrize("cell,overrides", [MIMO, L1K],
                         ids=["l2k-2x2", "l1k"])
def test_control_in_the_programs_place_is_not_correct(cell, overrides):
    _, m = measure(cell, overrides, control=True)
    assert not m["tally"].correct
    lines = m["tally"].lines()
    assert lines["phasor_gap"]["value"] > 3 * lines["phasor_gap"]["limit"]
    if cell == MIMO[0]:
        assert lines["chan_gap"]["value"] > 3 * lines["chan_gap"]["limit"]


def _broken(how, cfg):
    """A fault planted in what a 2x2 chain step returns."""
    def alter(r):
        if how == "bit":                  # one bit of each frame flipped
            bits = r.hard_bits.clone()
            bits[:, 0, 7] ^= 1
            return r._replace(hard_bits=bits)
        if how == "pointer":              # the lock one trial later
            return r._replace(lock_ptr=r.lock_ptr + cfg.stride)
        if how == "swap":                 # the two layers exchanged
            return r._replace(**{f: getattr(r, f).flip(1) for f in
                                 ("ber", "hard_bits", "phasors")})
        half = r.found.shape[0] // 2      # the second half of the batch
        return type(r)(*(torch.cat([f[:half], f[:half]]) for f in r))
    return alter


@pytest.mark.parametrize("how", ["bit", "pointer", "swap", "half_batch"])
def test_mimo_faults_are_not_correct(monkeypatch, how):
    from lte_gnu_radio_code_tpu_torch.models import mimo
    real = mimo.make_mimo_chain

    def make(cfg, *a, **k):
        step = real(cfg, *a, **k)
        alter = _broken(how, cfg)
        return lambda *x, **y: alter(step(*x, **y))
    monkeypatch.setattr(mimo, "make_mimo_chain", make)
    _, m = measure(*MIMO)
    assert m["tally"].checked and not m["tally"].correct, m["tally"].lines()


def _body(path) -> str:
    """The module's code without its docstring."""
    tree = ast.parse(pathlib.Path(path).read_text())
    return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))


def test_frozen_reference_is_the_ports():
    """``reference/mimo.py`` is ``reference_cpu/mimo.py`` but for its
    docstring, and gives the same arrays on the same frame."""
    from lte_gnu_radio_code_tpu_torch.reference_cpu import mimo as port
    from lte_gnu_radio_code_tpu_torch.utils.params import OFDMConfig
    assert _body(frozen.__file__) == _body(port.__file__)
    kw = dict(nfft=128, cp_len=32, num_ofdm_symb=64, synch_dat=(2, 6),
              num_data_bins=120, num_synch_bins=126, stride=31, snr_db=8.0)
    rc, pc = RefConfig(**kw), OFDMConfig(num_ant_txrx=2, **kw).validate()
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (2, pc.num_bits))
    n = pc.frame_len + pc.nfft - 1
    noise = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    for ar in ("FLOAT64", "TF32"):
        a = frozen.link_frame(rc, bits, noise, getattr(frozen, ar))
        b = port.link_frame(pc, bits, noise, getattr(port, ar))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_frozen_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; import ofdm_bench.reference.mimo; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(harness.ROOT))
    loaded = set(ast.literal_eval(out.stdout))
    assert not loaded & {"lte_gnu_radio_code_tpu_torch",
                         "lte_gnu_radio_code_tpu", "jax", "jaxlib"}


def test_detect_counts_by_hand():
    """l2k-2x2-link's step: 64 frames x 48 data symbols x 1,200 bins."""
    shape = dict(num_data_symb=48, num_data_bins=1200)
    # Y on both RX antennas read, both layers written, H at the data bins
    # read, complex64
    by_hand = 64 * (2 * 48 * 1200 * 8 * 2 + 4 * 1200 * 8)
    assert roof["detect_bytes"](64, **shape) == by_hand
    assert roof["detect_ops"](64, **shape) == 64 * 1200 * (80 + 40 * 48)
    least = max(by_hand / HBM_BYTES_PER_S,
                64 * 1200 * (80 + 40 * 48) / FP32_OPS_PER_S)
    assert roof["detect_least_s"](64, shape) == pytest.approx(least,
                                                              rel=1e-12)
    assert by_hand / HBM_BYTES_PER_S > 64 * 1200 * (80 + 40 * 48) / \
        FP32_OPS_PER_S                    # bound by bytes


def test_entry_hands_its_shape():
    spec = harness.cell_spec("l2k-2x2-link")
    from ofdm_bench.entries import mimo_chain
    e = mimo_chain.Entry(spec["config"], spec["traffic"], torch.device("cpu"))
    assert e.k4_shape() == dict(batch=64, n=165887, n_trials=315, nfft=2048,
                                cp=512, m_synch=1, num_data_symb=48,
                                num_data_bins=1200)


def test_new_readers_read_nothing_without_their_spans(monkeypatch):
    """A trace of a program without the 2x2 step's spans and counter (the
    parent's) gives no reading, and raises nothing."""
    from lte_gnu_radio_code_tpu_torch.utils import profiling
    profiling.reset_counters()
    tr = dict(host=[("ofdm.chain_step", 0.0, 10.0),
                    ("cudaLaunchKernel", 1.0, 2.0)],
              device=[("k", 3.0, 4.0)], steps=1, window_s=1e-5,
              launch_calls=1)
    ctx = dict(trace=tr, k4=dict(num_data_symb=48, num_data_bins=1200))
    for name in ("estimate_device_ms.link", "detect_device_ms.link",
                 "detect_roofline.link"):
        assert harness.metric_module(name).read(ctx) is None
    monkeypatch.setattr(profiling, "counters", lambda: {
        "ofdm.detect_frames": (128, 2)})
    tr["host"] += [("ofdm.detect", 0.5, 5.0)]
    assert harness.metric_module("detect_roofline.link").read(ctx) == \
        pytest.approx(100 * roof["detect_least_s"](64, ctx["k4"]) / 1e-6)
