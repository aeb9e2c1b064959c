"""The PyTorch port's trace helper, its numpy oracle and the BER
sweep's ``--check-oracle``, and its TX against the JAX package's four-step
one, on the CPU against the JAX package on numpy inputs made from a seed.

Exact: the oracle's arrays (the port's copy against the JAX package's),
and the oracle BER of the two CLIs.  Within 2e-5: K1's twin against the
four-step IDFT and TX (float32 rounding of a different product order)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu.cli import ber_sweep as jber_sweep
from lte_gnu_radio_code_tpu.models import txofdm as jtx
from lte_gnu_radio_code_tpu.ops import ofdm as jofdm
from lte_gnu_radio_code_tpu.reference_cpu import golden as jgolden
from lte_gnu_radio_code_tpu.utils import params as jparams
from lte_gnu_radio_code_tpu_torch.cli import ber_sweep
from lte_gnu_radio_code_tpu_torch.kernels import ofdm_mod
from lte_gnu_radio_code_tpu_torch.models import txofdm
from lte_gnu_radio_code_tpu_torch.reference_cpu import golden
from lte_gnu_radio_code_tpu_torch.utils import profiling
from torch_parity import port_cfg, reduced


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(logdir):
        torch.fft.fft(torch.ones(256, dtype=torch.complex64)).abs().sum()
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("fft" in e.get("name", "") for e in events)


@pytest.mark.parametrize("cfg", [jparams.GOLDEN64,
                                 reduced(jparams.GOLDEN64, nfft=128,
                                         cp_len=32, num_synch_bins=126,
                                         num_data_bins=120,
                                         num_ofdm_symb=24),
                                 reduced(jparams.GOLDEN64, num_ofdm_symb=48,
                                         channel="AWGN", snr_db=8.0)],
                         ids=["golden64", "nfft128", "awgn8db"])
def test_oracle_copy_equals_jax_oracle(cfg):
    """The port's reference_cpu/golden.py gives the JAX package's arrays
    exactly: TX, channel, AWGN, the offline RX, the stream RX and the whole
    chain, from the same seeds."""
    pcfg = port_cfg(cfg)
    bits = np.random.default_rng(1).integers(0, 2, cfg.num_bits)
    tx, jtx_ = golden.tx_frame(pcfg, bits), jgolden.tx_frame(cfg, bits)
    np.testing.assert_array_equal(tx, jtx_)
    h = golden.channel_taps("Fading")
    np.testing.assert_array_equal(h, jgolden.channel_taps("Fading"))
    rx = golden.awgn(pcfg, golden.apply_channel(tx, h, max_impulse=64),
                     np.random.default_rng(2), np.var(tx))
    jrx = jgolden.awgn(cfg, jgolden.apply_channel(jtx_, h, max_impulse=64),
                       np.random.default_rng(2), np.var(jtx_))
    np.testing.assert_array_equal(rx, jrx)
    for got, want in zip(golden.rx_frame(pcfg, rx),
                         jgolden.rx_frame(cfg, jrx)):
        np.testing.assert_array_equal(got, want)
    stream = np.concatenate([rx, rx])
    got, want = golden.rx_stream(pcfg, stream), jgolden.rx_stream(cfg, stream)
    assert type(got) is type(want)
    for g, w in zip(got.values() if isinstance(got, dict) else got,
                    want.values() if isinstance(want, dict) else want):
        np.testing.assert_array_equal(g, w)
    a, b = golden.run_chain(pcfg, seed=3), jgolden.run_chain(cfg, seed=3)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_ber_sweep_check_oracle_equals_jax_cli(capsys):
    argv = ["--snrs", "6", "12", "--num-ofdm-symb", "48", "--frames", "2",
            "--seed", "1", "--check-oracle", "--json"]
    got = ber_sweep.main(argv + ["--device", "cpu"])
    want = jber_sweep.main(argv)
    assert [r["oracle_ber"] for r in got] == [r["oracle_ber"] for r in want]
    assert got[0]["oracle_ber"] > got[1]["oracle_ber"] >= 0.0
    capsys.readouterr()
    ber_sweep.main(["--snrs", "12", "--num-ofdm-symb", "48", "--frames",
                    "1", "--check-oracle", "--device", "cpu"])
    assert "oracle" in capsys.readouterr().out
    qam = ber_sweep.main(["--snrs", "30", "--num-ofdm-symb", "48",
                          "--frames", "1", "--modulation", "QAM16",
                          "--check-oracle", "--json", "--device", "cpu"])
    assert "oracle_ber" not in qam[0]       # the oracle is BPSK / QPSK only


FOURSTEP_CFGS = {
    16: reduced(jparams.GOLDEN64, nfft=16, cp_len=4, num_synch_bins=14,
                num_data_bins=12, num_ofdm_symb=8),
    64: jparams.GOLDEN64, 1024: jparams.LTE1024, 2048: jparams.LTE2048}


@pytest.mark.parametrize("nfft", [16, 64, 1024, 2048])
def test_idft_fourstep_equals_jax_and_ifft(nfft):
    """K1's twin (the port's modulator on the CPU) against the JAX
    package's four-step IDFT, with its cyclic prefix and normalisation, and
    against the FFT form."""
    cfg = FOURSTEP_CFGS[nfft]
    rng = np.random.default_rng(nfft)
    grid = (rng.standard_normal((3, nfft)) +
            1j * rng.standard_normal((3, nfft))).astype(np.complex64)
    got = ofdm_mod.modulate_rows(port_cfg(cfg),
                                 torch.from_numpy(grid)).reshape(-1)
    np.testing.assert_allclose(got, np.asarray(jofdm.cp_and_normalise(
        cfg, jofdm.idft_fourstep(nfft, jnp.asarray(grid)))), atol=2e-5,
        rtol=0)
    np.testing.assert_allclose(got, np.asarray(jofdm.modulate(
        cfg, jnp.asarray(grid))), atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", ["GOLDEN64", "LTE1024"])
def test_tx_fourstep_equals_jax_and_the_default_path(name):
    """The port's TX against the JAX package's four-step TX and its
    default one."""
    cfg = reduced(getattr(jparams, name), num_ofdm_symb=8)
    pcfg = port_cfg(cfg)
    bits = np.random.default_rng(4).integers(0, 2, (2, cfg.num_bits))
    ours = txofdm.tx_frames(pcfg, torch.from_numpy(bits))
    one = txofdm.tx_frame(pcfg, torch.from_numpy(bits[0]))
    assert torch.equal(one, ours[0])
    for path in ("fourstep", None):
        want = jtx.tx_frames(cfg, jnp.asarray(bits, jnp.int32), path=path)
        np.testing.assert_allclose(ours, np.asarray(want), atol=2e-5, rtol=0)
