"""The frozen reference: its whole-array forms against its literal loops,
the literal loops against the port's own oracle, the reference against the
port's CPU twins at a tiny size, and what it loads."""

from __future__ import annotations

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from ofdm_bench import harness
from ofdm_bench.reference import golden, vector
from ofdm_bench.reference.numerology import RefConfig

SMALL = RefConfig(num_ofdm_symb=16)       # GOLDEN64's widths, 4 patterns
L2K = RefConfig(nfft=2048, cp_len=512, num_ofdm_symb=8, num_data_bins=1200,
                num_synch_bins=2046, stride=511)


def frames(cfg, f, snr_db, seed):
    rng = np.random.default_rng(seed)
    c = RefConfig(**{**cfg.__dict__, "snr_db": snr_db})
    bits = rng.integers(0, 2, (f, c.num_bits))
    n = c.frame_len + c.nfft - 1
    noise = rng.standard_normal((f, n)) + 1j * rng.standard_normal((f, n))
    return c, bits, noise


@pytest.mark.parametrize("cfg", [SMALL, L2K], ids=["g64", "l2k"])
def test_tx_and_channel_equal_the_literal_loops(cfg):
    c, bits, noise = frames(cfg, 2, 10.0, 1)
    tx = vector.tx_frames(c, bits)
    h = golden.channel_taps("Fading")
    for f in range(2):
        want = golden.tx_frame(c, bits[f])
        np.testing.assert_allclose(tx[f], want, atol=1e-12)
        np.testing.assert_allclose(
            vector.channel_frames(c, tx[f:f + 1], h)[0],
            golden.apply_channel(want, h, max_impulse=c.nfft), atol=1e-12)


@pytest.mark.parametrize("cfg,snr", [(SMALL, 6.0), (SMALL, 24.0),
                                     (L2K, 6.0)], ids=["g64-6", "g64-24",
                                                       "l2k-6"])
def test_rx_frame_equals_the_literal_loop(cfg, snr):
    c, bits, noise = frames(cfg, 3, snr, 2)
    x = vector.received(c, bits, noise)
    for f in range(3):
        ph, tsr, _ = golden.rx_frame(c, x[f])
        r = vector.rx_frame(c, x[f])
        assert r["found"] and r["lock_ptr"] == int(tsr[0])
        assert r["delay_idx"] == int(tsr[1])
        rows = r["in_buf"]
        np.testing.assert_allclose(r["phasors"][rows], ph[rows], atol=1e-10)
        want = golden.bit_recovery(ph)[0].reshape(len(ph), -1)
        np.testing.assert_array_equal(
            r["hard_bits"].reshape(len(ph), -1)[rows], want[rows])


def stream(cfg, n_frames, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_frames, cfg.num_bits))
    tx = vector.tx_frames(cfg, bits).reshape(-1)
    sig = golden.apply_channel(tx, golden.channel_taps("Fading"))
    return sig + 0.05 * (rng.standard_normal(len(sig)) +
                         1j * rng.standard_normal(len(sig)))


@pytest.mark.parametrize("cfg", [SMALL, L2K], ids=["g64", "l2k"])
def test_stream_detections_equal_the_literal_rx_stream(cfg):
    sig = stream(cfg, 3, 3)
    want = golden.rx_stream(cfg, sig, max_det=1000)
    got = vector.stream_detections(cfg, sig, 0, len(sig))
    np.testing.assert_array_equal(got["ptrs"], want["ptrs"])
    np.testing.assert_array_equal(got["delays"], want["delays"])
    np.testing.assert_array_equal(got["demod_ok"], want["demod_ok"])
    np.testing.assert_allclose(got["chans"], want["chans"], atol=1e-10)
    ok = want["demod_ok"]
    np.testing.assert_allclose(got["phasors"][ok], want["phasors"][ok],
                               atol=1e-10)
    assert len(got["ptrs"]) == 3 * cfg.num_patterns


def test_a_window_reports_its_range_only_and_follows_a_tie():
    cfg = SMALL
    sig = stream(cfg, 3, 4)
    whole = vector.stream_detections(cfg, sig, 0, len(sig))
    lo, hi = int(whole["ptrs"][3]), int(whole["ptrs"][7])
    part = vector.stream_detections(cfg, sig, lo, hi)
    np.testing.assert_array_equal(part["ptrs"], whole["ptrs"][3:7])
    # one sample later than the reference's own first crossing is a choice
    # only within a tie as wide as that trial's margin
    p = int(part["ptrs"][0])
    corr, _ = vector.search(cfg, sig, (p - cfg.cp_len) // cfg.stride + 2)
    t = (p - cfg.cp_len) // cfg.stride
    margin = corr[t].max() - vector.gate(cfg)
    follow = [(p + 1, int(corr[t + 1].argmax()))] + list(zip(
        part["ptrs"][1:].tolist(), part["delays"][1:].tolist()))
    strict = vector.stream_detections(cfg, sig, lo, hi, follow=follow,
                                      tie=margin / 2)
    assert strict["followed"] == 0 and strict["ptrs"][0] == p
    loose = vector.stream_detections(cfg, sig, lo, hi, follow=follow,
                                     tie=2 * margin + 1e-9)
    assert loose["followed"] == 1 and loose["ptrs"][0] == p + 1
    np.testing.assert_array_equal(loose["ptrs"][1:], part["ptrs"][1:])


def test_frozen_copy_equals_the_ports_oracle():
    from lte_gnu_radio_code_tpu_torch.reference_cpu import golden as port
    from lte_gnu_radio_code_tpu_torch.utils.params import OFDMConfig
    pc = OFDMConfig(num_ofdm_symb=16, snr_db=12.0).validate()
    c, bits, noise = frames(SMALL, 1, 12.0, 5)
    np.testing.assert_array_equal(golden.tx_frame(c, bits[0]),
                                  port.tx_frame(pc, bits[0]))
    x = vector.received(c, bits, noise)[0]
    a, b = golden.rx_frame(c, x), port.rx_frame(pc, x)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    sig = stream(SMALL, 2, 6)
    a, b = golden.rx_stream(c, sig), port.rx_stream(pc, sig)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("snr", [6.0, 24.0])
def test_reference_against_the_ports_cpu_chain(snr):
    """The port's ``chain_batch`` on the CPU (its plain twins) against the
    reference on the same bits and noise: decisions equal, phasors within
    the link cells' limit."""
    from lte_gnu_radio_code_tpu_torch.models import chain, rxofdm
    from lte_gnu_radio_code_tpu_torch.utils.params import OFDMConfig
    pc = OFDMConfig(num_ofdm_symb=16, snr_db=snr).validate()
    c, bits, noise = frames(SMALL, 4, snr, 7)
    n = pc.frame_len + pc.nfft - 1
    n_trials, n_pat = rxofdm.plan_rx(pc, n)
    out = chain.chain_batch(
        pc, chain.loopback_taps(pc), n_trials, n_pat,
        torch.as_tensor(bits, dtype=torch.int32),
        noise=torch.as_tensor(noise.astype(np.complex64)))
    x = vector.received(c, bits, noise)
    for f in range(4):
        r = vector.rx_frame(c, x[f])
        assert bool(out.found[f]) and r["found"]
        assert int(out.lock_ptr[f]) == r["lock_ptr"]
        assert int(out.delay_idx[f]) == r["delay_idx"]
        rows = r["in_buf"]
        gap = np.abs(out.phasors[f].numpy()[rows] - r["phasors"][rows]).max()
        assert gap < 1e-4


def test_tf32_rounds_to_ten_mantissa_bits():
    a = np.array([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                  -3.14159265], np.float32)
    got = vector._tf32(a)
    assert got[0] == 1.0 and got[1] == 1.0 + 2 ** -10
    assert got[2] == 1.0                    # a tie rounds to even
    assert got[3] == 1.0 + 2 ** -9
    assert abs(got[4] - a[4]) <= abs(a[4]) * 2 ** -11
    x = np.random.default_rng(0).standard_normal(1000)
    q = vector.TF32.q(x + 1j * x)
    assert np.abs(q.real - x).max() <= np.abs(x).max() * 2 ** -11


def test_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; import ofdm_bench.reference.vector, "
            "ofdm_bench.reference.golden; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(harness.ROOT))
    loaded = set(ast.literal_eval(out.stdout))
    assert not loaded & {"lte_gnu_radio_code_tpu_torch",
                         "lte_gnu_radio_code_tpu", "jax", "jaxlib", "torch"}


@pytest.mark.parametrize("snr", [6.0, 24.0])
def test_noise_power_is_the_literal_awgns(snr):
    c = RefConfig(num_ofdm_symb=16, snr_db=snr)
    rx = np.zeros(100, complex)
    got = golden.awgn(c, rx, np.random.default_rng(3), 1.7)
    rng = np.random.default_rng(3)
    n = rng.standard_normal(100) + 1j * rng.standard_normal(100)
    np.testing.assert_allclose(got, np.sqrt(vector.noise_power(c, 1.7) / 2)
                               * n, rtol=1e-14)
