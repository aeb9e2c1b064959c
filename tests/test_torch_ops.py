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
from lte_gnu_radio_code_tpu_torch.models import rxofdm, txofdm
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
    np.testing.assert_allclose(
        ofdm.modulate(port_cfg(cfg), grid).numpy(),
        np.asarray(jofdm.modulate(cfg, jnp.asarray(grid_ref))), atol=2e-5)


@pytest.mark.parametrize("path", [None, "kernel", "fused"])
def test_tx_frames_paths_match_jax(path):
    cfg = G24
    bits = np.random.default_rng(3).integers(0, 2, (2, cfg.num_bits),
                                             dtype=np.int32)
    ref = np.asarray(jtx.tx_frames(cfg, jnp.asarray(bits), path=None))
    out = txofdm.tx_frames(port_cfg(cfg), _t(bits), path=path)
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5)
    one = txofdm.tx_frame(port_cfg(cfg), _t(bits[0]), path=path)
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
    spec = sync.sync_spectra(pcfg, xt, n_trials)
    np.testing.assert_allclose(spec.numpy(), np.asarray(spec_ref),
                               atol=2e-4)
    for method in ("ifft", "exact"):
        ref = np.asarray(jsync.corr_abs_from_spectra(
            cfg, spec_ref, method if method == "ifft" else False))
        out = sync.corr_abs_from_spectra(pcfg, _t(spec_ref), method)
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-3)
    for method in (None, "dft"):
        for trial in (0, 7, n_trials - 1):
            ref = np.asarray(jsync.sync_spectrum_at(cfg, jnp.asarray(x),
                                                    trial, method=method))
            out = sync.sync_spectrum_at(pcfg, xt, trial, method=method)
            np.testing.assert_allclose(out.numpy(), ref, atol=2e-4)


def test_first_lock_matches_jax():
    cfg = G24
    rng = np.random.default_rng(6)
    gate = cfg.detection_gate * cfg.m_synch * cfg.num_synch_bins
    cases = [rng.uniform(0, 50, (40, 17)).astype(np.float32),
             np.zeros((40, 17), np.float32)]
    tie = np.zeros((40, 17), np.float32)
    tie[9, [3, 5]] = tie[12, 1] = np.float32(gate) + 1.0   # delay tie
    tie[8, 2] = np.float32(gate)                           # not above gate
    cases.append(tie)
    for corr in cases:
        ref = [np.asarray(a) for a in jsync.first_lock(cfg,
                                                       jnp.asarray(corr))]
        out = [a.numpy() for a in sync.first_lock(port_cfg(cfg), _t(corr))]
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(o, r)
    batched = sync.first_lock(port_cfg(cfg), _t(np.stack(cases)))
    assert batched[0].tolist() == [sync.first_lock(port_cfg(cfg), _t(c))[0]
                                   for c in cases]


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


@pytest.mark.parametrize("fast,jfast,eq", [
    ("ifft", "ifft", None), ("exact", False, None), ("conv", True, None),
    ("kernel", "pallas", "kernel")])
def test_rx_frame_paths_match_jax(fast, jfast, eq):
    cfg = G24
    x, bits = rx_buffer(cfg, seed=8, snr_db=8.0)
    ref = jrx.make_rx(cfg, len(x), fast=jfast,
                      eq="pallas" if eq else None)(jnp.asarray(x))
    out = rxofdm.make_rx(port_cfg(cfg), len(x), fast=fast, eq=eq)(_t(x))
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
    x = torch.zeros(5000, dtype=torch.complex64)
    for cfg in (dataclasses.replace(G24, modulation="QAM16"),
                dataclasses.replace(G24, pilot_grid="lte")):
        with pytest.raises(NotImplementedError):
            rxofdm.rx_frame(port_cfg(cfg), x, 10, 2)
