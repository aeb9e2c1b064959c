"""The PyTorch port's ops and RX/TX models against the JAX package's, on the
same numpy inputs (CPU, plain twins)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lte_gnu_radio_code_tpu.models import rxofdm as jrx
from lte_gnu_radio_code_tpu.models import txofdm as jtx
from lte_gnu_radio_code_tpu.ops import channel as jchan
from lte_gnu_radio_code_tpu.ops import modulation as jmodn
from lte_gnu_radio_code_tpu.ops import ofdm as jofdm
from lte_gnu_radio_code_tpu.ops import sync as jsync
from lte_gnu_radio_code_tpu.utils.params import GOLDEN64
from lte_gnu_radio_code_tpu_torch.kernels import ofdm_mod
from lte_gnu_radio_code_tpu_torch.models import rxofdm, stream_rx, txofdm
from lte_gnu_radio_code_tpu_torch.ops import channel, modulation, ofdm, sync
from torch_parity import port_cfg, reduced, rx_buffer

G24 = reduced(GOLDEN64, num_ofdm_symb=24)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("mod", ["BPSK", "QPSK"])
def test_bits_to_symbols_exact(mod):
    bits = np.random.default_rng(0).integers(0, 2, (3, 240), dtype=np.int32)
    ref = np.stack([np.asarray(jmodn.bits_to_symbols(jnp.asarray(b), mod))
                    for b in bits])
    out = modulation.bits_to_symbols(_t(bits), mod)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_qpsk_llr_matches_jax():
    rng = np.random.default_rng(1)
    ph = (0.7 * (rng.standard_normal((3, 90)) +
                 1j * rng.standard_normal((3, 90)))).astype(np.complex64)
    ph[0, :4] = [0.0, 1e-9j, -0.0, 1.5 + 0j]          # sign(0) ties
    for i in range(3):
        h_ref, l0_ref, l1_ref = (np.asarray(a) for a in
                                 jmodn.qpsk_llr(jnp.asarray(ph[i])))
        hard, l0, l1 = modulation.qpsk_llr(_t(ph[i]))
        np.testing.assert_array_equal(hard.numpy(), h_ref)
        np.testing.assert_allclose(l0.numpy(), l0_ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(l1.numpy(), l1_ref, rtol=1e-5, atol=1e-6)
    # per-frame sigma: the batched form equals the per-frame calls
    hard_b, l0_b, _ = modulation.qpsk_llr_frames(_t(ph))
    for i in range(3):
        hard, l0, _ = modulation.qpsk_llr(_t(ph[i]))
        assert torch.equal(hard_b[i], hard) and torch.equal(l0_b[i], l0)


def test_resource_grid_and_modulate_match_jax():
    cfg = G24
    bits = np.random.default_rng(2).integers(0, 2, cfg.num_bits,
                                             dtype=np.int32)
    pts = jmodn.bits_to_symbols(jnp.asarray(bits), cfg.modulation).reshape(
        cfg.num_data_symb, cfg.num_data_bins)
    grid_ref = np.asarray(jofdm.resource_grid(cfg, pts))
    grid = ofdm.resource_grid(port_cfg(cfg), _t(pts))
    np.testing.assert_array_equal(grid.numpy(), grid_ref)
    # K1's twin on the CPU: the modulator every port path takes
    np.testing.assert_allclose(
        ofdm_mod.modulate_rows(port_cfg(cfg), grid).reshape(-1).numpy(),
        np.asarray(jofdm.modulate(cfg, jnp.asarray(grid_ref))), atol=2e-5)


@pytest.mark.parametrize("path", [None, "pallas", "fused"])
def test_tx_frames_paths_match_jax(path):
    """The port's TX (K1's twin on the CPU) against each of the JAX
    package's TX paths: torch.fft's counterpart, its K1 and its grid-free
    fused form."""
    cfg = G24
    bits = np.random.default_rng(3).integers(0, 2, (2, cfg.num_bits),
                                             dtype=np.int32)
    ref = np.asarray(jtx.tx_frames(cfg, jnp.asarray(bits), path=path))
    out = txofdm.tx_frames(port_cfg(cfg), _t(bits))
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5)
    one = txofdm.tx_frame(port_cfg(cfg), _t(bits[0]))
    np.testing.assert_array_equal(one.numpy(), out[0].numpy())


@pytest.mark.parametrize("taps", [5, 40, 300], ids=["shifted-add", "conv1d",
                                                    "fft"])
def test_apply_channel_forms_match_jax(taps):
    rng = np.random.default_rng(taps)
    sig = (rng.standard_normal((2, 1500)) +
           1j * rng.standard_normal((2, 1500))).astype(np.complex64)
    h = (channel.channel_taps("Fading") if taps == 5 else
         (rng.standard_normal(taps) + 1j * rng.standard_normal(taps)
          ).astype(np.complex64) / np.sqrt(2 * taps))
    out = channel.apply_channel(_t(sig), h, max_impulse=64)
    for i in range(2):
        ref = np.asarray(jchan.apply_channel(jnp.asarray(sig[i]), h,
                                             max_impulse=64))
        np.testing.assert_allclose(out[i].numpy(), ref, atol=2e-5)


def test_awgn_matches_jax_formula():
    cfg = dataclasses.replace(G24, snr_db=5.0)
    rng = np.random.default_rng(4)
    rx = (rng.standard_normal((2, 100)) + 1j * rng.standard_normal((2, 100))
          ).astype(np.complex64)
    noise = (rng.standard_normal((2, 100)) +
             1j * rng.standard_normal((2, 100))).astype(np.complex64)
    sig_pow = np.array([0.5, 2.0], np.float32)
    nv = np.asarray(jchan.noise_variance(cfg, jnp.asarray(sig_pow)))
    ref = rx + np.sqrt(nv / 2.0)[:, None].astype(np.float32) * noise
    out = channel.awgn(port_cfg(cfg), _t(rx), _t(sig_pow)[:, None],
                       noise=_t(noise))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    drawn = channel.awgn(port_cfg(cfg), _t(rx), 1.0, generator=gen)
    assert drawn.shape == rx.shape and drawn.dtype == torch.complex64
    with pytest.raises(ValueError):
        channel.awgn(port_cfg(cfg), _t(rx), 1.0)


def test_sync_spectra_and_correlations_match_jax():
    cfg = G24
    x, _ = rx_buffer(cfg, seed=5, snr_db=20.0)
    n_trials, _ = jrx.plan_rx(cfg, len(x))
    pcfg, xt = port_cfg(cfg), _t(x)
    spec_ref = jsync.sync_spectra(cfg, jnp.asarray(x), n_trials)
    peak, delay = stream_rx.detect_trials(pcfg, xt, n_trials)
    for method in ("ifft", False):
        ref = np.asarray(jsync.corr_abs_from_spectra(cfg, spec_ref, method))
        np.testing.assert_allclose(peak.numpy(), ref.max(-1), atol=2e-3)
        np.testing.assert_array_equal(delay.numpy(), ref.argmax(-1))
    for method in (None, "dft"):
        for trial in (0, 7, n_trials - 1):
            ref = np.asarray(jsync.sync_spectrum_at(cfg, jnp.asarray(x),
                                                    trial, method=method))
            out = sync.sync_spectrum_at(pcfg, xt, trial)
            np.testing.assert_allclose(out.numpy(), ref, atol=2e-4)
            np.testing.assert_allclose(out.numpy(), np.asarray(
                spec_ref[trial]), atol=2e-4)


def _lock_cases(cfg):
    """Surfaces [40, 17] for the lock: seeded values, all zero, and a
    delay tie above the gate with a value on the gate before it."""
    rng = np.random.default_rng(6)
    gate = cfg.detection_gate * cfg.m_synch * cfg.num_synch_bins
    cases = [rng.uniform(0, 50, (40, 17)).astype(np.float32),
             np.zeros((40, 17), np.float32)]
    tie = np.zeros((40, 17), np.float32)
    tie[9, [3, 5]] = tie[12, 1] = np.float32(gate) + 1.0   # delay tie
    tie[8, 2] = np.float32(gate)                           # not above gate
    cases.append(tie)
    return cases


def _planted_ties(cfg):
    """More surfaces with equal values: across the delays of one trial
    (the lock's, one before it, and every delay of a trial), across trials
    (equal peaks, above and below the gate), and both at once."""
    gate = np.float32(cfg.detection_gate * cfg.m_synch * cfg.num_synch_bins)
    rng = np.random.default_rng(16)
    delays = rng.uniform(0, 1, (40, 17)).astype(np.float32)
    delays[4, [16, 2, 9]] = gate + 2.0          # lock at trial 4, delay 2
    delays[3, [0, 1]] = gate                    # on the gate: not a lock
    delays[30, :] = gate + 5.0                  # every delay equal
    trials = np.zeros((40, 17), np.float32)
    trials[[6, 7, 21], 11] = gate + 3.0         # equal peaks, lock at 6
    trials[[2, 5], 4] = gate - 1.0              # equal and below the gate
    both = np.full((40, 17), gate + 1.0, np.float32)   # every value equal
    return {"delays": delays, "trials": trials, "both": both}


def _assert_lock_matches_jax(cfg, corr, out):
    ref = [np.asarray(a) for a in jsync.first_lock(cfg, jnp.asarray(corr))]
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), r)


def _lock(cfg, corr):
    """The port's lock of a surface, as its receivers take it: each
    trial's peak and delay (K4's peaks form), then lock_from_peaks."""
    peak, delay = _t(corr).max(-1)
    return sync.lock_from_peaks(port_cfg(cfg), peak, delay.to(torch.int32))


def test_first_lock_matches_jax():
    cfg = G24
    cases = _lock_cases(cfg)
    for corr in cases:
        _assert_lock_matches_jax(cfg, corr, _lock(cfg, corr))
    batched = _lock(cfg, np.stack(cases))
    assert batched[0].tolist() == [_lock(cfg, c)[0] for c in cases]


@pytest.mark.parametrize("case", ["seeded", "zeros", "gate_tie", "delays",
                                  "trials", "both"])
def test_lock_from_peaks_matches_jax(case):
    """The lock from each trial's (peak, delay), the surface's one max(-1),
    equals the JAX package's first_lock on the surface: ties across delays
    go to the lowest delay, across trials to the first crossing."""
    cfg = G24
    cases = dict(zip(("seeded", "zeros", "gate_tie"), _lock_cases(cfg)),
                 **_planted_ties(cfg))
    _assert_lock_matches_jax(cfg, cases[case], _lock(cfg, cases[case]))


@pytest.mark.parametrize("batch", [None, 1, 3])
def test_sync_peaks_on_cpu_is_the_twins_max(batch):
    """On a CPU tensor K4's peaks form is the plain twin's surface reduced
    by max(-1), the delay as int32, with no launch counted."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.kernels import sync_search

    cfg = port_cfg(G24)
    x, _ = rx_buffer(G24, seed=17, snr_db=10.0)
    n_trials, _ = jrx.plan_rx(G24, len(x))
    xt = _t(x) if batch is None else _t(np.stack(
        [np.roll(x, 5 * i) for i in range(batch)]))
    kernels.reset_launch_counts()
    peak, delay = sync_search.sync_peaks(cfg, xt, n_trials)
    want, at = sync_search.sync_corr_abs_plain(cfg, xt, n_trials).max(-1)
    assert delay.dtype == torch.int32 and peak.dtype == torch.float32
    assert peak.shape == delay.shape == xt.shape[:-1] + (n_trials,)
    assert torch.equal(peak, want) and torch.equal(delay.long(), at)
    assert kernels.launch_counts()["sync_search"] == 0
    assert sync_search.peak_launches == {"fft": 0, "direct": 0}


def test_estimate_channel_and_mmse_match_jax():
    cfg = G24
    x, _ = rx_buffer(cfg, seed=7, snr_db=15.0)
    spec = np.array(jsync.sync_spectrum_at(cfg, jnp.asarray(x), 3))
    for delay in (0, 1, 16):
        ref = [np.asarray(a) for a in jsync.estimate_channel(
            cfg, jnp.asarray(spec), jnp.int32(delay))]
        out = sync.estimate_channel(port_cfg(cfg), _t(spec),
                                    torch.tensor(delay))
        for r, o in zip(ref, out):
            np.testing.assert_allclose(o.numpy(), r, atol=1e-5)
        np.testing.assert_allclose(
            sync.mmse_gain(out[1], cfg.snr_linear).numpy(),
            np.asarray(jsync.mmse_gain(jnp.asarray(ref[1]), cfg.snr_linear)),
            atol=1e-5)


@pytest.mark.parametrize("jfast,jeq", [
    ("ifft", None), (False, None), (True, None), ("pallas", "pallas")])
def test_rx_frame_paths_match_jax(jfast, jeq):
    """The port's RX (K4's and K2's twins on the CPU) against each of the
    JAX package's search and equaliser forms."""
    cfg = G24
    x, bits = rx_buffer(cfg, seed=8, snr_db=8.0)
    ref = jrx.make_rx(cfg, len(x), fast=jfast, eq=jeq)(jnp.asarray(x))
    out = rxofdm.make_rx(port_cfg(cfg), len(x))(_t(x))
    assert bool(out.found) and bool(ref.found)
    assert int(out.lock_ptr) == int(ref.lock_ptr)
    assert int(out.delay_idx) == int(ref.delay_idx)
    np.testing.assert_allclose(out.phasors.numpy(), np.asarray(ref.phasors),
                               atol=2e-4)
    np.testing.assert_array_equal(out.hard_bits.numpy(),
                                  np.asarray(ref.hard_bits))


def test_rx_frame_genie_channel_matches_jax():
    cfg = G24
    x, _ = rx_buffer(cfg, seed=9)
    h = np.concatenate([jchan.channel_taps("Fading"),
                        np.zeros(cfg.nfft - 5, np.complex64)])
    ref = jrx.make_rx(cfg, len(x), genie_h=h,
                      perfect_chan_est=True)(jnp.asarray(x))
    out = rxofdm.make_rx(port_cfg(cfg), len(x), genie_h=h,
                         perfect_chan_est=True)(_t(x))
    np.testing.assert_allclose(out.chan_est_time.numpy(),
                               np.asarray(ref.chan_est_time), atol=1e-5)
    np.testing.assert_array_equal(out.hard_bits.numpy(),
                                  np.asarray(ref.hard_bits))


def test_unported_configs_raise():
    """QAM and pilot configs, which raised until they were ported, run; what
    no package knows still raises."""
    x = torch.zeros(5000, dtype=torch.complex64)
    for cfg in (dataclasses.replace(G24, modulation="QAM16"),
                dataclasses.replace(G24, pilot_grid="lte")):
        r = rxofdm.rx_frame(port_cfg(cfg), x, 10, 2)
        assert not bool(r.found) and r.hard_bits.shape == (
            2 * cfg.synch_dat[1] * cfg.num_data_only_bins * cfg.bits_per_bin,)
    with pytest.raises(ValueError, match="pilot_grid"):
        rxofdm.rx_frame(port_cfg(dataclasses.replace(G24, pilot_grid="comb")),
                        x, 10, 2)
    with pytest.raises(KeyError):
        rxofdm.rx_frame(port_cfg(dataclasses.replace(G24, modulation="PSK8")),
                        x, 10, 2)
