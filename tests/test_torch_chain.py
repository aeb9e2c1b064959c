"""The port's loopback chain (``models.chain.chain_batch``) against the JAX
package's chain composed from its own public functions, on one shared numpy
noise array: locks, delays and hard bits must match exactly."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu.models import rxofdm as jrx
from lte_gnu_radio_code_tpu.models import txofdm as jtx
from lte_gnu_radio_code_tpu.ops import channel as jchan
from lte_gnu_radio_code_tpu.ops import sync as jsync
from lte_gnu_radio_code_tpu.pallas_kernels import channel_conv as jconv
from lte_gnu_radio_code_tpu.pallas_kernels import equalize as jeq
from lte_gnu_radio_code_tpu.pallas_kernels import sync_search as jsearch
from lte_gnu_radio_code_tpu.utils.params import GOLDEN64, LTE1024
from lte_gnu_radio_code_tpu_torch.cli import ofdm_chain
from lte_gnu_radio_code_tpu_torch.models import chain
from torch_parity import port_cfg, reduced

TINY = 1e-4     # a phasor component this close to 0 may decide either way


def _inputs(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, cfg.num_bits), dtype=np.int32)
    n = cfg.frame_len + cfg.nfft - 1
    noise = (rng.standard_normal((batch, n)) +
             1j * rng.standard_normal((batch, n))).astype(np.complex64)
    return bits, noise


def _jax_front(cfg, bits, noise):
    """TX (K1) -> channel (K3) -> per-frame AWGN from the shared noise."""
    tx = jtx.tx_frames(cfg, jnp.asarray(bits), path="pallas")
    clean = jconv.apply_channel_frames(tx, jchan.channel_taps("Fading"),
                                       cfg.nfft)
    sig_pow = jnp.mean(jnp.abs(tx - jnp.mean(tx, axis=1, keepdims=True))
                       ** 2, axis=1)
    nv = jchan.noise_variance(cfg, sig_pow)
    return clean + (jnp.sqrt(nv / 2.0).astype(jnp.float32)[:, None] *
                    jnp.asarray(noise))


def _jax_lock_and_phasors(cfg, n_trials, num_patterns, x):
    """The per-frame part of rxofdm.rx_frames_batch, returning the delay
    and the phasors that function keeps internal."""
    corr = jsearch.sync_corr_abs(cfg, x, n_trials, interpret=True)
    ptr, delay, _, _, first = jsync.first_lock(cfg, corr)
    spec = jsync.sync_spectrum_at(cfg, x, first, method="dft")
    _, chan_full, _ = jsync.estimate_channel(cfg, spec, delay)
    win = jeq.data_windows(cfg, x, ptr, num_patterns)
    coeff = jeq.combined_coeff(cfg, delay, chan_full)
    return delay, jeq.demod_windows(cfg, win, coeff, interpret=True)


def _port_chain(cfg, bits, noise, **kw):
    pcfg = port_cfg(cfg)
    n_trials, num_patterns = chain.rxofdm.plan_rx(pcfg, noise.shape[1])
    return chain.chain_batch(pcfg, chain.loopback_taps(pcfg), n_trials,
                             num_patterns, torch.from_numpy(bits),
                             noise=torch.from_numpy(noise), **kw)


def _check_bits(ours, ref, phasors):
    """Hard bits equal, except where the JAX phasor component is tiny;
    prints how many such bits differ."""
    comp = np.stack([phasors.real, phasors.imag], -1).reshape(
        phasors.shape[0], -1)
    differ = ours != ref
    assert not (differ & (np.abs(comp) >= TINY)).any(), int(differ.sum())
    print(f"bits differing at a tiny phasor component: {int(differ.sum())}")


@pytest.mark.parametrize("snr_db", [100.0, 5.0])
def test_chain_batch_matches_jax_golden64(snr_db):
    cfg = dataclasses.replace(GOLDEN64, snr_db=snr_db)
    bits, noise = _inputs(cfg, 2, seed=11)
    n_trials, num_patterns = jrx.plan_rx(cfg, noise.shape[1])
    rxs = _jax_front(cfg, bits, noise)
    hard, found, ptr = jax.jit(functools.partial(
        jrx.rx_frames_batch, cfg, n_trials=n_trials,
        num_patterns=num_patterns))(rxs)
    delay, phasors = jax.jit(jax.vmap(functools.partial(
        _jax_lock_and_phasors, cfg, n_trials, num_patterns)))(rxs)
    r = _port_chain(cfg, bits, noise)
    np.testing.assert_array_equal(r.found.numpy(), np.asarray(found))
    np.testing.assert_array_equal(r.lock_ptr.numpy(), np.asarray(ptr))
    np.testing.assert_array_equal(r.delay_idx.numpy(), np.asarray(delay))
    assert r.found.all()
    _check_bits(r.hard_bits.numpy(), np.asarray(hard), np.asarray(phasors))
    if snr_db == 100.0:
        assert float(r.ber.max()) == 0.0
        assert np.all(np.asarray(hard) == bits)
    else:
        assert 0.0 < float(r.ber.mean()) < 0.3


@pytest.mark.parametrize("noise_db", [-100.0, -5.0])
def test_chain_batch_matches_jax_lte1024(noise_db):
    """noise_db -5 scales the shared noise to a 5 dB Digital SNR while the
    config (and so its constant tables, costly to build at NFFT 1024) stays
    the 100 dB one; the RX's MMSE regulariser then stays at 100 dB."""
    cfg = reduced(LTE1024, num_ofdm_symb=8)
    bits, noise = _inputs(cfg, 1, seed=12)
    noise *= np.float32(10 ** ((noise_db + cfg.snr_db) / 20))
    n_trials, num_patterns = jrx.plan_rx(cfg, noise.shape[1])
    x = _jax_front(cfg, bits, noise)[0]
    ref = jax.jit(functools.partial(
        jrx.rx_frame, cfg, n_trials=n_trials, num_patterns=num_patterns,
        fast="conv"))(x)
    r = _port_chain(cfg, bits, noise)
    assert bool(r.found[0]) and bool(ref.found)
    assert int(r.lock_ptr[0]) == int(ref.lock_ptr)
    assert int(r.delay_idx[0]) == int(ref.delay_idx)
    _check_bits(r.hard_bits.numpy(), np.asarray(ref.hard_bits)[None],
                np.asarray(ref.phasors)[None])
    if noise_db == -100.0:
        assert float(r.ber[0]) == 0.0
    else:
        assert 0.0 < float(r.ber[0]) < 0.3


def test_plain_chain_matches_kernel_chain():
    """The port's chain (on the CPU the kernels' twins) against the JAX
    package's plain chain on the same shared noise: its jnp.fft TX, its
    shifted-add channel and rx_frame with its default search and FFT
    equaliser, frame by frame."""
    cfg = dataclasses.replace(GOLDEN64, snr_db=5.0)
    bits, noise = _inputs(cfg, 2, seed=13)
    a = _port_chain(cfg, bits, noise)
    n_trials, num_patterns = jrx.plan_rx(cfg, noise.shape[1])
    for i in range(2):
        tx = jtx.tx_frame(cfg, jnp.asarray(bits[i]))
        clean = jchan.apply_channel(tx, jchan.channel_taps("Fading"),
                                    max_impulse=cfg.nfft)
        nv = jchan.noise_variance(cfg, jnp.mean(jnp.abs(tx - jnp.mean(tx))
                                                ** 2))
        ref = jrx.rx_frame(cfg, clean + jnp.sqrt(nv / 2.0).astype(
            jnp.float32) * jnp.asarray(noise[i]), n_trials, num_patterns)
        assert (bool(a.found[i]), int(a.lock_ptr[i]), int(a.delay_idx[i])) \
            == (bool(ref.found), int(ref.lock_ptr), int(ref.delay_idx))
        # K1's and K2's twins round otherwise than jnp.fft
        np.testing.assert_allclose(a.phasors[i], np.asarray(ref.phasors),
                                   atol=2e-4, rtol=0)
        _check_bits(a.hard_bits[i:i + 1].numpy(),
                    np.asarray(ref.hard_bits)[None],
                    np.asarray(ref.phasors)[None])


def test_make_chain_loopback_golden64():
    pcfg = port_cfg(GOLDEN64)
    bits = torch.from_numpy(np.random.default_rng(42).integers(
        0, 2, pcfg.num_bits, dtype=np.int32))
    out = chain.make_chain(pcfg)(bits,
                                 generator=torch.Generator().manual_seed(7))
    assert bool(out.found) and float(out.ber) == 0.0
    assert (int(out.lock_ptr), int(out.delay_idx)) == (16, 1)


def test_cli_loopback(capsys):
    out = ofdm_chain.main(["--json", "--device", "cpu"])
    assert out == {"found": True, "lock_ptr": 16, "delay_idx": 1,
                   "ber": 0.0}
    assert '"found": true' in capsys.readouterr().out


def test_cli_runs_on_the_card_by_default(monkeypatch):
    """--device defaults to cuda, and without a CUDA device the CLI raises
    instead of moving to the CPU."""
    assert ofdm_chain.build_parser().parse_args([]).device == "cuda"
    assert ofdm_chain.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda"], ["--device", "cuda:0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ofdm_chain.main(argv)


def test_single_frame_batch_hands_k2_contiguous_rows(monkeypatch):
    """With one frame the per-row coefficients are an expanded view; the
    batched RX must hand K2 contiguous rows (its CUDA wrapper refuses any
    other), as the CLI's one-frame loopback does on the card."""
    from lte_gnu_radio_code_tpu_torch.kernels import equalize
    seen = []
    real = equalize.demod_windows

    def spy(cfg, win, coeff):
        seen.append((win.is_contiguous(), coeff.is_contiguous(),
                     tuple(coeff.shape)))
        return real(cfg, win, coeff)

    monkeypatch.setattr(equalize, "demod_windows", spy)
    out = ofdm_chain.main(["--json", "--device", "cpu"])
    assert out["found"] and out["ber"] == 0.0
    k = GOLDEN64.num_data_symb
    assert seen == [(True, True, (k, GOLDEN64.num_data_bins))]
