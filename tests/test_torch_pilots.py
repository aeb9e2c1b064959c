"""Scattered pilots through the PyTorch port on the CPU, against the JAX
package on numpy inputs made from a seed: the pilot plan and values, both
interpolators, the pilot resource grid and TX, the pilot equaliser and the
pilot chain for QPSK / QAM16 / QAM64, and LTE1024 on the "linear" route.

Exact: plans, values, grids, locks, delays and hard bits (a bit may differ
only where its phasor lies within the phasor tolerance of a decision
boundary).  Within tolerance: interpolated channels 2e-5, TX frames 2e-5,
phasors 2e-4 (the JAX package's own, tests/test_pallas.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu.models import rxofdm as jrx
from lte_gnu_radio_code_tpu.models import txofdm as jtx
from lte_gnu_radio_code_tpu.ops import channel as jchan
from lte_gnu_radio_code_tpu.ops import ofdm as jofdm
from lte_gnu_radio_code_tpu.ops import pilots as jpilots
from lte_gnu_radio_code_tpu.utils import params as jparams
from lte_gnu_radio_code_tpu.utils.params import GOLDEN64, LTE1024
from lte_gnu_radio_code_tpu_torch.kernels import equalize
from lte_gnu_radio_code_tpu_torch.models import chain, rxofdm, txofdm
from lte_gnu_radio_code_tpu_torch.ops import ofdm, pilots
from lte_gnu_radio_code_tpu_torch.utils import params as tparams
from torch_parity import (assert_bits_equal_or_on_boundary, jax_rx_buffer,
                          port_cfg, reduced)

PHASOR_ATOL = 2e-4
GRIDS = {
    "lte4": dict(pilot_grid="lte", pilot_spacing=4),
    "lte6": dict(pilot_grid="lte", pilot_spacing=6),
    "random": dict(pilot_grid="random", ref_sigs=0.3),
}
SHORT = reduced(GOLDEN64, num_ofdm_symb=48)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_pilot_plan_and_values_equal_jax(grid):
    cfg = reduced(GOLDEN64, **GRIDS[grid])
    pcfg = port_cfg(cfg)
    assert tparams.pilot_bin_plan(pcfg) == jparams.pilot_bin_plan(cfg)
    for prop in ("num_pilot_bins", "num_data_only_bins", "num_bits"):
        assert getattr(pcfg, prop) == getattr(cfg, prop) > 0, prop
    assert hash(pcfg) == hash(port_cfg(cfg))         # the plan's cache key
    ours, ref = pilots.pilot_values(pcfg), jpilots.pilot_values(cfg)
    assert ours.dtype == ref.dtype == np.complex64
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(pilots._cir_interp_matrix(pcfg),
                                  jpilots._cir_interp_matrix(cfg))
    assert pilots._cir_condition(pcfg) == jpilots._cir_condition(cfg)
    none = port_cfg(GOLDEN64)
    assert none.num_pilot_bins == 0 and tparams.pilot_bin_plan(none)[0] == ()
    with pytest.raises(ValueError, match="pilot_grid"):
        tparams.pilot_bin_plan(port_cfg(reduced(GOLDEN64, pilot_grid="comb")))


@pytest.mark.parametrize("interp", ["cir", "linear", "auto"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_channel_from_pilots_equals_jax(grid, interp):
    """Both interpolators (and the route "auto" takes) against the JAX
    function on seeded pilot-bin values, with two leading dimensions."""
    cfg = reduced(GOLDEN64, snr_db=20.0, **GRIDS[grid])
    pcfg = port_cfg(cfg)
    rng = np.random.default_rng(4)
    shape = (2, 3, 5, cfg.num_pilot_bins)
    fp = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
          ).astype(np.complex64)
    ours = pilots.estimate_channel_from_pilots(pcfg, torch.from_numpy(fp),
                                               interp)
    assert ours.shape == (2, 3, cfg.num_data_only_bins)
    assert ours.dtype == torch.complex64
    for i in range(2):
        for j in range(3):
            ref = jpilots.estimate_channel_from_pilots(
                cfg, jnp.asarray(fp[i, j]), interp)
            np.testing.assert_allclose(ours[i, j], np.asarray(ref),
                                       atol=2e-5, rtol=0)


def test_linear_plan_is_numpy_interp_and_auto_picks_both_routes():
    """The (left, weight) plan applied to a ramp and to noise is np.interp,
    data bins outside a random grid's span included; "auto" takes "cir" at
    the small grids and "linear" at LTE1024 with spacing 6."""
    for grid in GRIDS:
        pcfg = port_cfg(reduced(GOLDEN64, **GRIDS[grid]))
        p_signed, _, d_signed, _ = tparams.pilot_bin_plan(pcfg)
        left, w = pilots._linear_interp_plan(pcfg)
        assert left.dtype == np.int64 and w.dtype == np.float32
        assert left.min() >= 0 and left.max() <= len(p_signed) - 2
        h = np.random.default_rng(5).standard_normal(len(p_signed))
        got = h[left] + w * (h[left + 1] - h[left])
        np.testing.assert_allclose(got, np.interp(d_signed, p_signed, h),
                                   atol=1e-6)
        assert pilots.interp_route(pcfg) == "cir"
    lte = port_cfg(reduced(LTE1024, num_ofdm_symb=16, pilot_grid="lte",
                           pilot_spacing=6))
    assert pilots._cir_condition(lte) > 1e4
    assert pilots.interp_route(lte) == "linear"
    assert pilots.interp_route(lte, "cir") == "cir"


@pytest.mark.parametrize("grid", list(GRIDS))
def test_pilot_resource_grid_and_tx_equal_jax(grid):
    """The grid exactly; tx_frames (K1's twin on the CPU) within 2e-5 of
    the JAX package's TX, and of its "fused" path, which gives way to the
    grid path through its K1."""
    cfg = reduced(SHORT, modulation="QAM16", **GRIDS[grid])
    pcfg = port_cfg(cfg)
    bits = np.random.default_rng(6).integers(0, 2, (2, cfg.num_bits),
                                             dtype=np.int32)
    grids = txofdm._grid(pcfg, torch.from_numpy(bits))
    assert grids.shape == (2, cfg.num_ofdm_symb, cfg.nfft)
    for r in range(2):
        np.testing.assert_array_equal(
            grids[r], np.asarray(jtx._grid(cfg, jnp.asarray(bits[r]))))
    ref = np.stack([np.asarray(jtx.tx_frame(cfg, jnp.asarray(b)))
                    for b in bits])
    ours = txofdm.tx_frames(pcfg, torch.from_numpy(bits))
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(ours, np.asarray(jtx.tx_frames(
        cfg, jnp.asarray(bits), path="fused")), atol=2e-5, rtol=0)
    one = txofdm.make_tx(pcfg)(torch.from_numpy(bits[0]))
    np.testing.assert_allclose(one, ref[0], atol=2e-5, rtol=0)
    win = np.random.default_rng(7).standard_normal((3, cfg.nfft)).astype(
        np.complex64)
    np.testing.assert_allclose(
        ofdm.symbol_fft(pcfg, torch.from_numpy(win)),
        np.asarray(jofdm.symbol_fft(cfg, jnp.asarray(win))), atol=2e-5)


@pytest.mark.parametrize("grid,snr_db", [("lte4", 30.0), ("lte6", 30.0),
                                         ("random", 30.0), ("lte4", 12.0)])
def test_pilot_equaliser_equals_jax(grid, snr_db):
    """equalize_data_symbols_pilot (K2 with the rotation alone: on the CPU
    its plain twin): phasors and the interpolated channel within tolerance
    of the JAX package's, one frame and two at once."""
    cfg = reduced(SHORT, snr_db=snr_db, **GRIDS[grid])
    pcfg = port_cfg(cfg)
    bufs = np.stack([jax_rx_buffer(cfg, 70 + s, snr_db)[0]
                     for s in range(2)])
    ptr, delay = np.array([16, 17]), np.array([1, 0])
    ph, h = pilots.equalize_data_symbols_pilot(
        pcfg, torch.from_numpy(bufs), torch.from_numpy(ptr),
        torch.from_numpy(delay), cfg.num_patterns, return_chan=True)
    assert ph.shape == (2, cfg.num_data_symb, cfg.num_data_only_bins)
    for r in range(2):
        jph, jh = jpilots.equalize_data_symbols_pilot(
            cfg, jnp.asarray(bufs[r]), int(ptr[r]), int(delay[r]),
            cfg.num_patterns, return_chan=True)
        np.testing.assert_allclose(ph[r], np.asarray(jph), atol=PHASOR_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(h[r], np.asarray(jh), atol=2e-5, rtol=0)
        one = pilots.equalize_data_symbols_pilot(
            pcfg, torch.from_numpy(bufs[r]), int(ptr[r]), int(delay[r]),
            cfg.num_patterns)
        torch.testing.assert_close(one, ph[r], atol=2e-6, rtol=0)


def test_pilot_equaliser_gives_k2_the_rotation_alone(monkeypatch):
    """The pilot equaliser is one K2 call over every window of every frame with
    contiguous rows and a unit-modulus coefficient row a window: the
    rotation alone."""
    cfg = reduced(SHORT, **GRIDS["lte4"])
    pcfg = port_cfg(cfg)
    seen = []
    real = equalize.demod_windows

    def spy(cfg_, win, coeff):
        seen.append((win, coeff))
        return real(cfg_, win, coeff)

    monkeypatch.setattr(equalize, "demod_windows", spy)
    bufs = torch.from_numpy(np.stack([jax_rx_buffer(cfg, 80 + s)[0]
                                      for s in range(3)]))
    n_trials, num_patterns = rxofdm.plan_rx(pcfg, bufs.shape[1])
    r = rxofdm.rx_frames_batch(pcfg, bufs, n_trials, num_patterns)
    (win, coeff), = seen
    k = num_patterns * cfg.synch_dat[1]
    assert win.shape == (3 * k, cfg.nfft) and win.is_contiguous()
    assert coeff.shape == (3 * k, cfg.num_data_bins) and coeff.is_contiguous()
    torch.testing.assert_close(coeff.abs(), torch.ones(3 * k,
                                                       cfg.num_data_bins))
    assert bool(r.found.all()) and r.hard_bits.shape == (3, cfg.num_bits)


def _jax_front(cfg, bits, noise):
    """The JAX package's TX, Fading channel and AWGN from a shared noise."""
    tx = jtx.tx_frame(cfg, jnp.asarray(bits))
    clean = jchan.apply_channel(tx, jchan.channel_taps("Fading"),
                                max_impulse=cfg.nfft)
    sig_pow = jnp.mean(jnp.abs(tx - jnp.mean(tx)) ** 2)
    nv = jchan.noise_variance(cfg, sig_pow)
    return clean + jnp.sqrt(nv / 2.0).astype(jnp.float32) * jnp.asarray(noise)


@pytest.mark.parametrize("mod,snr_db", [("QPSK", 100.0), ("QAM16", 100.0),
                                        ("QAM64", 100.0), ("QAM16", 16.0),
                                        ("QAM64", 24.0)])
def test_pilot_chain_equals_jax_on_shared_noise(mod, snr_db):
    """The pilot chain (``chain_batch``, on the CPU the kernels' twins)
    against the JAX chain on one shared noise array: found, lock, delay
    exact; hard bits exact or on a boundary; BER 0 at 100 dB."""
    cfg = reduced(SHORT, modulation=mod, snr_db=snr_db, **GRIDS["lte4"])
    pcfg = port_cfg(cfg)
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, (2, cfg.num_bits), dtype=np.int32)
    n = cfg.frame_len + cfg.nfft - 1
    noise = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
             ).astype(np.complex64)
    n_trials, num_patterns = jrx.plan_rx(cfg, n)
    refs = [jrx.rx_frame(cfg, _jax_front(cfg, bits[r], noise[r]), n_trials,
                         num_patterns) for r in range(2)]
    r = chain.chain_batch(pcfg, chain.loopback_taps(pcfg), n_trials,
                          num_patterns, torch.from_numpy(bits),
                          noise=torch.from_numpy(noise))
    for i, ref in enumerate(refs):
        assert (bool(r.found[i]), int(r.lock_ptr[i]),
                int(r.delay_idx[i])) == (bool(ref.found), int(ref.lock_ptr),
                                         int(ref.delay_idx))
        d = assert_bits_equal_or_on_boundary(
            r.hard_bits[i], ref.hard_bits, ref.phasors, cfg, PHASOR_ATOL)
        print(f"{mod} {snr_db} dB frame {i}: {d} symbols decided otherwise "
              "on a boundary")
    if snr_db == 100.0:
        assert float(r.ber.max()) == 0.0
    else:
        assert 0.0 < float(r.ber.mean()) < 0.1


def test_lte1024_pilot_chain_on_the_linear_route():
    """LTE1024 at 16 symbols, QAM64, pilots every 6 bins: "auto" takes the
    piecewise-linear interpolator; rx_frame on one shared buffer gives the
    JAX package's lock, delay, phasors and bits, and the sent bits."""
    cfg = reduced(LTE1024, num_ofdm_symb=16, modulation="QAM64",
                  pilot_grid="lte", pilot_spacing=6)
    pcfg = port_cfg(cfg)
    assert pilots.interp_route(pcfg) == "linear"
    rx, bits = jax_rx_buffer(cfg, 9)
    ref = jrx.make_rx(cfg, len(rx))(jnp.asarray(rx))
    r = rxofdm.make_rx(pcfg, len(rx))(torch.from_numpy(rx))
    assert (bool(r.found), int(r.lock_ptr), int(r.delay_idx)) == (
        bool(ref.found), int(ref.lock_ptr), int(ref.delay_idx))
    np.testing.assert_allclose(r.phasors, np.asarray(ref.phasors),
                               atol=PHASOR_ATOL, rtol=0)
    assert_bits_equal_or_on_boundary(r.hard_bits, ref.hard_bits,
                                     ref.phasors, cfg, PHASOR_ATOL)
    np.testing.assert_array_equal(r.hard_bits, bits)
