"""QAM through the PyTorch port on the CPU, against the JAX package on numpy
inputs made from a seed: the Gray mapping and its tables, the max-log demap,
the pair-swapped QPSK demap, the MMSE unbias gain, ``rx_frame`` on noisy
Fading buffers, ``rx_frame`` with a frame axis, ``ber_sweep`` and the CLIs.

Exact: the mapping, the tables, hard bits, locks and delays.  Within
tolerance: LLRs 1e-4 relative to their scale, phasors 2e-4 (the JAX
package's own, tests/test_pallas.py).  A hard bit may differ from the JAX
package's only where its phasor lies within that 2e-4 of a decision
boundary; the tests print how many do."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu.models import rxofdm as jrx
from lte_gnu_radio_code_tpu.ops import modulation as jmod
from lte_gnu_radio_code_tpu.ops import sync as jsync
from lte_gnu_radio_code_tpu.utils.params import GOLDEN64
from lte_gnu_radio_code_tpu_torch.cli import ber_sweep as cli_ber_sweep
from lte_gnu_radio_code_tpu_torch.cli import ofdm_chain
from lte_gnu_radio_code_tpu_torch.models import chain, rxofdm
from lte_gnu_radio_code_tpu_torch.ops import modulation, sync
from torch_parity import (assert_bits_equal_or_on_boundary, jax_rx_buffer,
                          port_cfg, reduced)

PHASOR_ATOL = 2e-4
MODS = ["BPSK", "QPSK", "QAM16", "QAM64"]


@pytest.mark.parametrize("mod", ["QAM16", "QAM64"])
def test_qam_mapping_equals_jax(mod):
    """The table gather gives the JAX package's one-hot select exactly,
    with and without leading dimensions."""
    bps = modulation.BITS_PER_SYMBOL[mod]
    bits = np.random.default_rng(0).integers(0, 2, (3, 512 * bps),
                                             dtype=np.int32)
    ours = modulation.bits_to_symbols(torch.from_numpy(bits), mod)
    assert ours.dtype == torch.complex64 and ours.shape == (3, 512)
    for r in range(3):
        ref = np.asarray(jmod.bits_to_symbols(jnp.asarray(bits[r]), mod))
        np.testing.assert_array_equal(ours[r].numpy(), ref)
        np.testing.assert_array_equal(
            modulation.bits_to_symbols(torch.from_numpy(bits[r]), mod), ref)
    assert abs(float((ours.abs() ** 2).mean()) - 1.0) < 5e-2


@pytest.mark.parametrize("mod", MODS)
def test_constellation_tables_equal_jax(mod):
    pts, bit_tbl = modulation._constellation_table(mod)
    jpts, jbits = jmod._constellation_table(mod)
    assert pts.dtype == jpts.dtype and bit_tbl.dtype == jbits.dtype
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(bit_tbl, jbits)
    np.testing.assert_array_equal(modulation.QAM16_PAM, jmod.QAM16_PAM)
    np.testing.assert_array_equal(modulation.QAM64_PAM, jmod.QAM64_PAM)
    np.testing.assert_array_equal(modulation.QPSK_POINTS, jmod.QPSK_POINTS)
    assert modulation.BITS_PER_SYMBOL == jmod.BITS_PER_SYMBOL


def _noisy_points(mod, n, seed, sigma=0.05):
    rng = np.random.default_rng(seed)
    pts, _ = jmod._constellation_table(mod)
    return (pts[rng.integers(0, len(pts), n)] +
            sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


@pytest.mark.parametrize("mod", MODS)
def test_maxlog_llr_equals_jax(mod):
    """Hard bits exact, LLRs within 1e-4 of their scale, on noisy points
    that crowd the decision boundaries; a tensor noise variance too."""
    noisy = _noisy_points(mod, 4096, 1)
    nv = 2 * 0.05 ** 2
    hard, llr = modulation.maxlog_llr(torch.from_numpy(noisy), mod, nv)
    jhard, jllr = jmod.maxlog_llr(jnp.asarray(noisy), mod, nv)
    jllr = np.asarray(jllr)
    assert hard.dtype == torch.int32 and hard.shape == llr.shape == jllr.shape
    np.testing.assert_array_equal(hard, np.asarray(jhard))
    np.testing.assert_allclose(llr, jllr, rtol=1e-4,
                               atol=1e-4 * np.abs(jllr).max())
    shaped = modulation.maxlog_llr(
        torch.from_numpy(noisy.reshape(4, 8, 128)), mod, torch.tensor(nv))
    assert torch.equal(shaped[0], hard)


def test_qpsk_llr_pairswap_equals_jax():
    """The pair-swapped demap: hard bits (ceil tie-break) exact, both LLR
    rails within 1e-4 of their scale, zero components included."""
    noisy = _noisy_points("QPSK", 2048, 2, sigma=0.2)
    noisy[:4] = [0.0, 0.7 + 0j, 0.7j, -0.7 - 0.0j]
    ours = modulation.qpsk_llr_pairswap(torch.from_numpy(noisy.reshape(32, 64)))
    ref = jmod.qpsk_llr_pairswap(jnp.asarray(noisy))
    np.testing.assert_array_equal(ours[0], np.asarray(ref[0]))
    for a, b in zip(ours[1:], ref[1:]):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())


def test_demap_unbias_gain_equals_jax():
    rng = np.random.default_rng(3)
    h = (rng.standard_normal((4, 64)) + 1j * rng.standard_normal((4, 64))
         ).astype(np.complex64)
    h[0, :3] = 0.0                       # empty slots: the clamp, no NaN
    for snr_lin in (10.0, 1e5, 1e8):
        ours = sync.demap_unbias_gain(torch.from_numpy(h), snr_lin)
        ref = np.asarray(jsync.demap_unbias_gain(jnp.asarray(h), snr_lin))
        assert ours.dtype == torch.float32 and bool(torch.isfinite(ours).all())
        np.testing.assert_allclose(ours, ref, rtol=1e-5)


@pytest.mark.parametrize("jfast,jeq", [(None, None), (True, None),
                                      ("pallas", "pallas")])
@pytest.mark.parametrize("mod,snr_db", [("QAM16", 14.0), ("QAM64", 22.0)])
def test_rx_frame_qam_equals_jax_on_a_noisy_buffer(mod, snr_db, jfast, jeq):
    """One shared noisy Fading buffer through both packages' rx_frame, the
    JAX one in each of its search and equaliser forms: lock, delay and
    found exact, hard bits exact (or on a boundary), phasors within 2e-4,
    LLRs within 1e-4 of their scale plus what 2e-4 of phasor moves them;
    the buffer carries bit errors, so the grid is exercised."""
    cfg = reduced(GOLDEN64, modulation=mod, snr_db=snr_db)
    rx, bits = jax_rx_buffer(cfg, 100, snr_db)
    ref = jrx.make_rx(cfg, len(rx), fast=jfast, eq=jeq)(jnp.asarray(rx))
    r = rxofdm.make_rx(port_cfg(cfg), len(rx))(torch.from_numpy(rx))
    assert (bool(r.found), int(r.lock_ptr), int(r.delay_idx)) == (
        bool(ref.found), int(ref.lock_ptr), int(ref.delay_idx))
    assert r.hard_bits.shape == (cfg.num_bits,) and r.hard_bits.dtype == \
        torch.int32
    np.testing.assert_allclose(r.phasors, np.asarray(ref.phasors),
                               atol=PHASOR_ATOL, rtol=0)
    n = assert_bits_equal_or_on_boundary(r.hard_bits, ref.hard_bits,
                                         ref.phasors, cfg, PHASOR_ATOL)
    print(f"{mod} {jfast}/{jeq}: {n} symbols decided otherwise on a "
          "boundary")
    assert torch.equal(r.llr0, -r.llr1)
    errors = int((np.asarray(ref.hard_bits) != bits).sum())
    assert 0 < errors < 0.1 * cfg.num_bits


@pytest.mark.parametrize("mod", ["QPSK", "QAM16"])
def test_rx_frame_with_a_frame_axis_equals_frame_by_frame(mod):
    """x [2, 2, n] gives what each buffer gives alone: the counterpart of
    jax.vmap(rx_frame), the QPSK demap's sigma a mean over each frame."""
    cfg = reduced(GOLDEN64, modulation=mod, num_ofdm_symb=48, snr_db=15.0)
    pcfg = port_cfg(cfg)
    bufs = np.stack([jax_rx_buffer(cfg, 40 + s, 15.0 - 3 * s)[0]
                     for s in range(4)])
    n_trials, num_patterns = rxofdm.plan_rx(pcfg, bufs.shape[1])
    both = rxofdm.rx_frame(pcfg, torch.from_numpy(bufs.reshape(2, 2, -1)),
                           n_trials, num_patterns)
    assert both.hard_bits.shape == (2, 2, cfg.num_bits)
    assert both.phasors.shape[:2] == both.lock_ptr.shape == (2, 2)
    for i in range(4):
        one = rxofdm.rx_frame(pcfg, torch.from_numpy(bufs[i]), n_trials,
                              num_patterns)
        ref = jrx.rx_frame(cfg, jnp.asarray(bufs[i]), n_trials, num_patterns)
        for f in one._fields:
            x, y = getattr(one, f), getattr(both, f)[i // 2, i % 2]
            if x.dtype.is_floating_point or x.dtype.is_complex:
                torch.testing.assert_close(x, y, atol=2e-5, rtol=1e-5)
            else:
                assert torch.equal(x, y), (f, i)
        assert int(one.lock_ptr) == int(ref.lock_ptr)
        assert_bits_equal_or_on_boundary(one.hard_bits, ref.hard_bits,
                                         ref.phasors, cfg, PHASOR_ATOL)


def test_rx_frames_batch_qam_kernel_path_equals_plain_and_rx_frame():
    """The whole-batch RX for QAM64 (on the CPU the plain twins) ==
    rx_frame over the batch == rx_frame frame by frame, and locks every
    frame where the JAX package's batch RX does."""
    cfg = reduced(GOLDEN64, modulation="QAM64", num_ofdm_symb=48)
    pcfg = port_cfg(cfg)
    xs = torch.from_numpy(np.stack([jax_rx_buffer(cfg, 60 + s, 24.0)[0]
                                    for s in range(3)]))
    n_trials, num_patterns = rxofdm.plan_rx(pcfg, xs.shape[1])
    a = rxofdm.rx_frames_batch(pcfg, xs, n_trials, num_patterns)
    r = rxofdm.rx_frame(pcfg, xs, n_trials, num_patterns)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(r, f)), f
    for i in range(3):
        one = rxofdm.rx_frame(pcfg, xs[i], n_trials, num_patterns)
        assert torch.equal(a.hard_bits[i], one.hard_bits)
    _, jfound, jptr = jrx.rx_frames_batch(cfg, jnp.asarray(xs.numpy()),
                                          n_trials, num_patterns)
    assert a.lock_ptr.tolist() == np.asarray(jptr).tolist()
    assert bool(a.found.all()) and bool(np.asarray(jfound).all())


def test_ber_sweep_shape_and_monotone(monkeypatch):
    """{snr_db: ber} with float keys, BER falling with the SNR to 0; on the
    CUDA device unless asked for the CPU."""
    cfg = port_cfg(reduced(GOLDEN64, modulation="QAM16", num_ofdm_symb=48))
    out = chain.ber_sweep(cfg, [4, 14, 60], seeds=range(2), device="cpu")
    assert list(out) == [4.0, 14.0, 60.0]
    assert out[4.0] > out[14.0] > out[60.0] == 0.0 and out[4.0] < 0.5
    assert out == chain.ber_sweep(cfg, [4, 14, 60], seeds=range(2),
                                  device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chain.ber_sweep(cfg, [60])


@pytest.mark.parametrize("config,want", [
    ("configs/qam64_sweep.json", dict(found=True, lock_ptr=16, delay_idx=1)),
    ("configs/tx16qam.json", dict(found=True, lock_ptr=16, delay_idx=0,
                                  ber=0.0)),
    ("configs/rx_recorded.json", dict(found=True, lock_ptr=16, delay_idx=1,
                                      ber=0.0))])
def test_cli_runs_the_shipped_qam_and_pilot_configs(config, want):
    out = ofdm_chain.main(["--json", "--device", "cpu", "--config", config])
    assert {k: out[k] for k in want} == want
    assert 0.0 <= out["ber"] < 0.05
    with open(config) as f:
        raw = json.load(f)
    flags = ["--modulation", raw["modulation"], "--snr", str(raw["snr_db"]),
             "--channel", raw["channel"],
             "--pilot-grid", raw.get("pilot_grid", "none"),
             "--pilot-spacing", str(raw.get("pilot_spacing", 4))]
    assert ofdm_chain.main(["--json", "--device", "cpu"] + flags) == out


def test_cli_ber_sweep(monkeypatch, capsys):
    rows = cli_ber_sweep.main(["--device", "cpu", "--json", "--config",
                               "configs/qam64_sweep.json", "--snrs", "10",
                               "40", "--frames", "2"])
    assert [r["snr_db"] for r in rows] == [10.0, 40.0]
    assert rows[0]["ber"] > 0.05 and rows[1]["ber"] == 0.0
    assert json.loads(capsys.readouterr().out) == rows
    assert cli_ber_sweep.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_ber_sweep.main(["--snrs", "10"])
