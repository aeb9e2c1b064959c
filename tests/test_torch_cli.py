"""The port's command-line apps with ``--device cpu`` against the JAX
package's on the same pickles in ``tmp_path``: the pickle and streaming
modes of ``cli/ofdm_chain.py``, ``cli/rx_file.py``, ``cli/tx_file.py``,
``cli/sdrscript.py`` and ``cli/grc_import.py``.  Locks, delays, detection
tables and BER equal; TX samples within the TX tolerance (2e-5,
tests/test_pallas.py).  Frames are cut to 48 symbols to keep the JAX
compiles short."""

import dataclasses

import numpy as np
import pytest

from lte_gnu_radio_code_tpu.cli import grc_import as jgrc_import
from lte_gnu_radio_code_tpu.cli import ofdm_chain as jofdm_chain
from lte_gnu_radio_code_tpu.cli import rx_file as jrx_file
from lte_gnu_radio_code_tpu.cli import sdrscript as jsdrscript
from lte_gnu_radio_code_tpu.cli import tx_file as jtx_file
from lte_gnu_radio_code_tpu.io import pickles as jio
from lte_gnu_radio_code_tpu.reference_cpu import golden as G
from lte_gnu_radio_code_tpu.utils import params as jparams
from lte_gnu_radio_code_tpu_torch.cli import (grc_import, ofdm_chain,
                                              rx_file, sdrscript, tx_file)
from test_torch_io import write_graphs
from torch_parity import rx_buffer

CPU = ["--device", "cpu"]
SHORT = ["--num-ofdm-symb", "48"]
TX_ATOL = 2e-5


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A 48-symbol GOLDEN64 frame over Fading at 60 dB and its bits, as
    pickles."""
    d = tmp_path_factory.mktemp("cap")
    cfg = dataclasses.replace(jparams.GOLDEN64, num_ofdm_symb=48).validate()
    rx, bits = rx_buffer(cfg, 0, snr_db=60.0)
    jio.save_pickle_iq(d / "rx.pckl", rx[None])
    jio.save_pickle_iq(d / "bits.pckl", bits[None])
    return str(d / "rx.pckl"), str(d / "bits.pckl")


@pytest.mark.parametrize("mode", [[], ["--stream", "960", "--repeat", "2"]],
                         ids=["batch", "stream"])
def test_ofdm_chain_pickle_equals_jax(capture, mode):
    rx, bits = capture
    argv = SHORT + ["--tx-pickle", rx, "--bits-pickle", bits] + mode
    ours = ofdm_chain.main(CPU + argv)
    assert ours == jofdm_chain.main(argv)
    assert ours["ber"] == 0.0
    if mode:
        assert ours["detections"] == 2 * 12
    else:
        assert ours["found"] and ours["lock_ptr"] == 16


def test_ofdm_chain_synthetic_stream_and_diag(tmp_path):
    """The synthetic stream (the port's own TX and channel) finds what the
    JAX CLI's numpy frame gives; the loopback and the pickle mode write
    their diagnostics."""
    argv = SHORT + ["--stream", "960", "--repeat", "2"]
    assert ofdm_chain.main(CPU + argv) == jofdm_chain.main(argv)
    out = ofdm_chain.main(CPU + SHORT + ["--diag-dir", str(tmp_path)])
    assert out["found"] and out["ber"] == 0.0
    rx = tmp_path / "rx.pckl"
    cfg = dataclasses.replace(jparams.GOLDEN64, num_ofdm_symb=48).validate()
    jio.save_pickle_iq(rx, rx_buffer(cfg, 1)[0][None])
    ofdm_chain.main(CPU + SHORT + ["--tx-pickle", str(rx), "--diag-dir",
                                   str(tmp_path)])
    assert len(list(tmp_path.glob("chan_est_*.pckl"))) == 1


def _legacy_capture(path, case, frames=2):
    cfg = jparams.config_from_case(jparams.CFO_CASES, case, snr_db=1e8)
    rng = np.random.default_rng(3)
    rx = np.concatenate([
        G.apply_channel(G.tx_frame(cfg, rng.integers(0, 2, cfg.num_bits)),
                        G.channel_taps("Fading"), max_impulse=cfg.nfft)
        for _ in range(frames)])
    jio.save_pickle_iq(path, rx[None])
    return str(path)


@pytest.mark.parametrize("case,extra", [
    (0, []), (0, ["--stream", "960"]), (7, ["--stream", "2048"]),
    (1, ["--dsss", "1", "--fo-range", "0", "-1500", "1500"])])
def test_rx_file_equals_jax(tmp_path, case, extra):
    """Whole buffer and --stream, CFO and DSSS tables: the JAX CLI's
    detections, pointers, delays and candidates."""
    iq = _legacy_capture(tmp_path / "iq.pckl", case)
    argv = [iq, "--case", str(case), "--json"] + extra
    ours = rx_file.main([argv[0]] + CPU + argv[1:])
    assert ours == jrx_file.main(argv)
    assert ours["detections"] > 0


def test_tx_file_generate_and_replay_equal_jax(tmp_path):
    """--generate writes the JAX CLI's frame (within the TX tolerance) that
    the port's receiver decodes; replay streams the same samples."""
    ours = tx_file.main([str(tmp_path / "gen.pckl")] + CPU +
                        ["--generate", "--num-symbols", "48", "--json"])
    ref = jtx_file.main([str(tmp_path / "jgen.pckl"), "--generate",
                         "--num-symbols", "48", "--json"])
    a = jio.load_pickle_iq(tmp_path / "gen.pckl")
    b = jio.load_pickle_iq(tmp_path / "jgen.pckl")
    assert ours["samples"] == ref["samples"] == a.size
    np.testing.assert_allclose(a, b, atol=TX_ATOL)

    faded = G.apply_channel(a.ravel(), G.channel_taps("Fading"),
                            max_impulse=64)
    jio.save_pickle_iq(tmp_path / "faded.pckl", faded[None])
    out = ofdm_chain.main(CPU + SHORT + ["--tx-pickle",
                                         str(tmp_path / "faded.pckl")])
    assert out["found"] and out["lock_ptr"] == 16

    jio.save_pickle_iq(tmp_path / "tx_data_0.pckl", a)
    for mod, name in ((tx_file, "replay.npy"), (jtx_file, "jreplay.npy")):
        mod.main([str(tmp_path / name), "--pickle-dir", str(tmp_path),
                  "--file-stem", "tx_data_", "--repeat", "2", "--chunk",
                  "1000", "--json"])
    np.testing.assert_array_equal(np.load(tmp_path / "replay.npy"),
                                  np.load(tmp_path / "jreplay.npy"))


def test_sdrscript_equals_jax(tmp_path):
    """One Eb/N0 point of profile 0 at 48 symbols: the same lock and BER,
    and the TX hand-off pickle within the TX tolerance."""
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    argv = ["--num-symbols", "48", "--ebno-db", "100", "--json"]
    ours = sdrscript.main(CPU + argv + ["--out-dir", str(tmp_path / "p")])
    ref = jsdrscript.main(argv + ["--out-dir", str(tmp_path / "j")])
    assert ours == ref and ours[0]["ber"] == 0.0
    np.testing.assert_allclose(
        jio.load_pickle_iq(tmp_path / "p" / "4g5g_input_data.pckl"),
        jio.load_pickle_iq(tmp_path / "j" / "4g5g_input_data.pckl"),
        atol=TX_ATOL)


def test_grc_import_run_equals_jax(tmp_path, capture):
    """The YAML loopback graph (synthetic, then on a capture) and the XML
    legacy graph on a capture with BitRecovery and its BER."""
    yaml_grc, xml_grc = map(str, write_graphs(tmp_path))
    ours = grc_import.main([yaml_grc] + CPU + ["--run", "--json", "-o",
                                               str(tmp_path / "c.json")])
    ref = jgrc_import.main([yaml_grc, "--run", "--json"])
    assert ours["run"] == ref["run"] and ours["run"]["ber"] == 0.0
    assert ours["config"] == ref["config"]
    rx, bits = capture
    argv = [yaml_grc, "--run", "--tx-pickle", rx, "--bits-pickle", bits,
            "--json"]
    assert grc_import.main([argv[0]] + CPU + argv[1:])["run"] == \
        jgrc_import.main(argv)["run"]

    cfg = jparams.config_from_case(jparams.CFO_CASES, 0, snr_db=1e8)
    sent = np.random.default_rng(4).integers(0, 2, cfg.num_bits)
    cap = G.apply_channel(G.tx_frame(cfg, sent), G.channel_taps("Fading"),
                          max_impulse=cfg.nfft)
    jio.save_pickle_iq(tmp_path / "cap.pckl", cap[None])
    jio.save_pickle_iq(tmp_path / "sent.pckl", sent[None])
    argv = [xml_grc, "--run", "--tx-pickle", str(tmp_path / "cap.pckl"),
            "--bits-pickle", str(tmp_path / "sent.pckl"), "--json"]
    ours = grc_import.main([argv[0]] + CPU + argv[1:])["run"]
    assert ours == jgrc_import.main(argv)["run"]
    assert ours["detections"] > 0 and ours["hard_bits"] > 0
