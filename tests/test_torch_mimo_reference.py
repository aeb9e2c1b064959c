"""The port's 2x2 spatial multiplexing (``models/mimo.py:make_mimo_chain``,
on the CPU, where K4 runs its plain twin) against its plain float64
reference (``reference_cpu/mimo.py``) on seeded bits and noise, at nfft 128
with synch_dat (2, 6) and 64 symbols and at ``tests/test_torch_mimo.py``'s
configuration, at 24 and 6 dB; the search view that lets a 2x2 frame of any
whole number of patterns run; and the outputs of the configurations that
ran before it, unchanged bit for bit.

Exact: found, lock_ptr, delay_idx, and the hard bits of both streams (a bit
may differ only where the reference's phasor lies within the phasor
tolerance of a decision boundary).  Within tolerance, each about ten times
the port's own float32 rounding here and far below what one precision less
gives (the reference at TF32, which each test also holds outside them):

- phasors 5e-5: the port's float32 FFTs of <= 128 points, the closed-form
  2x2 inverse and the unit-power scale leave it within 4e-6 of float64;
  the TF32 reference lies 2e-3 to 4e-3 away;
- chan_freq 1e-5: one float32 FFT and one scale, within 8e-7; TF32 9e-4."""

import dataclasses

import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu_torch.models import mimo
from lte_gnu_radio_code_tpu_torch.reference_cpu import golden
from lte_gnu_radio_code_tpu_torch.reference_cpu import mimo as ref
from lte_gnu_radio_code_tpu_torch.utils.params import (SDR_PROFILES,
                                                       OFDMConfig,
                                                       config_from_profile)
from ofdm_bench.judge import rail_margin

PHASOR_ATOL = 5e-5
CHAN_ATOL = 1e-5
FRAMES = 3

N128 = OFDMConfig(nfft=128, cp_len=32, num_ofdm_symb=64, synch_dat=(2, 6),
                  num_data_bins=120, num_synch_bins=126, stride=31,
                  num_ant_txrx=2).validate()
TEST_CFG = OFDMConfig(synch_dat=(2, 2), num_ofdm_symb=48,
                      num_ant_txrx=2).validate()
WIFI = dataclasses.replace(config_from_profile(SDR_PROFILES[1]),
                           synch_dat=(2, 2), snr_db=100.0).validate()


def _inputs(cfg, seed, frames=FRAMES):
    """(bits [frames, 2, num_bits], unit noise [frames, 2, n]) as numpy."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (frames, 2, cfg.num_bits), dtype=np.int32)
    n = cfg.frame_len + cfg.nfft - 1
    noise = (rng.standard_normal((frames, 2, n)) +
             1j * rng.standard_normal((frames, 2, n)))
    return bits, noise


def _port(cfg, bits, noise):
    step = mimo.make_mimo_chain(cfg, device="cpu")
    return step(torch.from_numpy(bits),
                noise=torch.from_numpy(noise.astype(np.complex64)))


@pytest.mark.parametrize("snr", [24.0, 6.0])
@pytest.mark.parametrize("cfg", [N128, TEST_CFG], ids=["nfft128-2x6",
                                                       "test-cfg"])
def test_port_equals_the_plain_reference(cfg, snr):
    cfg = dataclasses.replace(cfg, snr_db=snr)
    bits, noise = _inputs(cfg, 40 + int(snr))
    out = _port(cfg, bits, noise)
    for f in range(FRAMES):
        r = ref.link_frame(cfg, bits[f], noise[f])
        assert r["found"] and bool(out.found[f])
        assert int(out.lock_ptr[f]) == r["lock_ptr"]
        assert int(out.delay_idx[f]) == r["delay_idx"]
        want_ph = r["phasors"].numpy()
        ph = out.phasors[f].numpy()
        ch = out.chan_freq[f].numpy()
        assert np.abs(ph - want_ph).max() <= PHASOR_ATOL
        assert np.abs(ch - r["chan_freq"].numpy()).max() <= CHAN_ATOL
        hard = out.hard_bits[f].numpy()
        for s in range(2):
            differ = hard[s] != r["hard_bits"][s]
            assert not (differ & (rail_margin(want_ph[s]).reshape(-1) >
                                  PHASOR_ATOL)).any()
        np.testing.assert_allclose(out.ber[f].numpy(), r["ber"], atol=1e-6)
        # one precision below the port's lies outside both tolerances
        low = ref.link_frame(cfg, bits[f], noise[f], ref.TF32)
        assert np.abs(low["phasors"].numpy() - want_ph).max() > \
            10 * PHASOR_ATOL
        assert np.abs(low["chan_freq"].numpy() -
                      r["chan_freq"].numpy()).max() > 10 * CHAN_ATOL
    if snr == 24.0:
        assert float(out.ber.max()) == 0.0


def test_reference_recovers_a_clean_frame_and_the_channel():
    """At 100 dB every bit of both streams comes back through the 2x2
    Fading channel, the lock at the first trial; the estimate is the true
    channel up to one factor a TX antenna (its pilot row's own energy
    scale, CP included); each TX row carries unit mean power, and a pilot
    row is silent on the other antenna."""
    cfg = dataclasses.replace(N128, snr_db=100.0)
    bits, noise = _inputs(cfg, 7, frames=1)
    r = ref.link_frame(cfg, bits[0], noise[0])
    assert r["found"] and r["lock_ptr"] == cfg.cp_len
    np.testing.assert_array_equal(r["hard_bits"], bits[0])
    hf = torch.fft.fft(ref.mimo2_taps(), cfg.nfft).numpy()
    rot = np.exp(2j * np.pi * r["delay_idx"] * np.arange(cfg.nfft) /
                 cfg.nfft)
    sb = ref._bins(cfg.nfft, cfg.num_synch_bins).numpy()
    ratio = r["chan_freq"].numpy()[..., sb] / (hf * rot)[..., sb]
    np.testing.assert_allclose(ratio / ratio[:1, :, :1], 1.0, atol=1e-4)
    assert abs(ratio[0, 0, 0] / ratio[0, 1, 0] - 1) < 0.02
    tx = ref.tx_frame(cfg, bits[0]).reshape(2, cfg.num_ofdm_symb, -1)
    power = (tx.abs() ** 2).mean(-1)
    pilot = torch.tensor(cfg.symbol_pattern()) == 0
    np.testing.assert_allclose(power[:, ~pilot].numpy(), 1.0, atol=1e-12)
    assert float(power[0, 1]) == 0.0 and float(power[1, 0]) == 0.0
    np.testing.assert_allclose(power[0, 0].item(), 1.0, atol=1e-12)
    np.testing.assert_allclose(power[1, 1].item(), 1.0, atol=1e-12)


def test_reference_channel_and_noise_are_the_equations():
    """The 2x2 channel is each RX antenna's sum of full convolutions; the
    noise is added at golden.awgn's variance for the mean TX power."""
    cfg = dataclasses.replace(N128, snr_db=10.0)
    bits, noise = _inputs(cfg, 8, frames=1)
    tx = ref.tx_frame(cfg, bits[0]).numpy()
    h = ref.mimo2_taps().numpy()
    want = np.zeros((2, tx.shape[-1] + cfg.nfft - 1), complex)
    for r in range(2):
        for t in range(2):
            c = np.convolve(tx[t], h[r, t])
            want[r, :len(c)] += c
    clean = ref.channel(cfg, torch.from_numpy(tx), torch.from_numpy(h))
    np.testing.assert_allclose(clean.numpy(), want, atol=1e-12)
    y = ref.received(cfg, bits[0], noise[0]).numpy()
    p = np.mean(np.abs(tx) ** 2)
    nv = (1 / (cfg.num_data_bins * 2)) * cfg.rx_b_len * p * 10 ** (-1.0)
    np.testing.assert_allclose(y - want, np.sqrt(nv / 2) * noise[0],
                               atol=1e-12)
    # golden.awgn's own variance for the same power
    g = golden.awgn(cfg, np.zeros(4, complex), np.random.default_rng(0), p)
    rng = np.random.default_rng(0)
    w = rng.standard_normal(4) + 1j * rng.standard_normal(4)
    np.testing.assert_allclose(g, np.sqrt(nv / 2) * w, rtol=1e-12)


def test_tf32_rounds_to_ten_mantissa_bits():
    a = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11,
                      1.0 + 3 * 2 ** -11, -3.14159265])
    got = ref._tf32(a)
    assert got[0] == 1.0 and got[1] == 1.0 + 2 ** -10
    assert got[2] == 1.0                    # a tie rounds to even
    assert got[3] == 1.0 + 2 ** -9
    assert abs(float(got[4] - a[4])) <= abs(float(a[4])) * 2 ** -11


@pytest.mark.parametrize("synch_dat", [(2, 2), (2, 6)])
def test_a_64_symbol_2x2_frame_builds_and_runs(synch_dat):
    """64 symbols are a whole number of (2, 2) and (2, 6) patterns but of
    neither (1, 2) nor (1, 6): the search's view is one pattern long, so
    the frame builds and its chain runs."""
    cfg = dataclasses.replace(N128, synch_dat=synch_dat, snr_db=100.0)
    view = mimo.search_config(cfg)
    assert view.synch_dat == (1, synch_dat[1]) and view.num_ant_txrx == 1
    assert view.num_ofdm_symb == 1 + synch_dat[1]
    for field in ("nfft", "cp_len", "stride", "num_synch_bins",
                  "detection_gate", "zc_prime"):
        assert getattr(view, field) == getattr(cfg, field)
    bits, noise = _inputs(cfg, 9, frames=2)
    out = _port(cfg, bits, noise)
    assert bool(out.found.all()) and float(out.ber.max()) == 0.0
    assert out.phasors.shape == (2, 2, cfg.num_data_symb, cfg.num_data_bins)
    assert out.chan_freq.shape == (2, 2, 2, cfg.nfft)
    stc = mimo.make_stcode_chain(cfg, device="cpu")(
        torch.from_numpy(bits[:, 0]),
        noise=torch.from_numpy(noise.astype(np.complex64)))
    assert bool(stc.found.all()) and float(stc.ber.max()) == 0.0


def _old_view(cfg):
    """The search's view before it was one pattern long: every symbol of
    the frame kept."""
    return dataclasses.replace(cfg, synch_dat=(1, cfg.synch_dat[1]),
                               num_ant_txrx=1).validate()


@pytest.mark.parametrize("mode", ["spmult", "stcode"])
@pytest.mark.parametrize("cfg", [TEST_CFG, WIFI], ids=["test-cfg",
                                                       "wifimimosm-a"])
def test_configs_that_ran_before_give_the_same_outputs(monkeypatch, cfg,
                                                       mode):
    """Each output field of both chains, at 12 dB and at the config's own
    SNR, bit for bit equal to the chain run with the old search view."""
    make = mimo.make_mimo_chain if mode == "spmult" else \
        mimo.make_stcode_chain
    for snr in (12.0, cfg.snr_db):
        c = dataclasses.replace(cfg, snr_db=snr)
        bits, noise = _inputs(c, 10)
        b = torch.from_numpy(bits if mode == "spmult" else bits[:, 0])
        w = torch.from_numpy(noise.astype(np.complex64))
        new = make(c, device="cpu")(b, noise=w)
        with monkeypatch.context() as m:
            m.setattr(mimo, "search_config", _old_view)
            old = make(c, device="cpu")(b, noise=w)
        for name in new._fields:
            x, y = getattr(new, name), getattr(old, name)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert torch.equal(x.contiguous().view(torch.uint8),
                               y.contiguous().view(torch.uint8)), name
