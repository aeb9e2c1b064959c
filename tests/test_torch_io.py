"""The port's file and flowgraph layer on the CPU (``io/pickles.py``,
``runtime/flowgraph.py``, ``utils/diagnostics.py``, ``io/grc.py``) against
the JAX package's modules on the same files in ``tmp_path``: what one
writes the other reads, and both give the same values, sources, graphs and
plans."""

import dataclasses
import json
import pickle

import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu.io import grc as jgrc
from lte_gnu_radio_code_tpu.io import pickles as jio
from lte_gnu_radio_code_tpu.runtime import flowgraph as jfg
from lte_gnu_radio_code_tpu.utils import diagnostics as jdiag
from lte_gnu_radio_code_tpu.utils import params as jparams
from lte_gnu_radio_code_tpu_torch.io import grc
from lte_gnu_radio_code_tpu_torch.io import pickles as io
from lte_gnu_radio_code_tpu_torch.runtime import flowgraph as fg
from lte_gnu_radio_code_tpu_torch.runtime import stream as rt
from lte_gnu_radio_code_tpu_torch.utils import diagnostics as diag
from torch_parity import port_cfg, rx_buffer

YAML_GRC = """\
options:
  parameters: {id: ofdm_chain}
blocks:
- name: samp_rate
  id: variable
  parameters: {value: '960000'}
- name: fft1
  id: variable
  parameters: {value: '64'}
- name: RXOFDM_synch_and_chan_est_0
  id: RXOFDM_synch_and_chan_est
  parameters: {nfft: fft1, cp_len: fft1/4, num_ofdm_symb: '48',
               synch_dat: '[1, 3]', num_data_bins: '60', num_synch_bins: '64',
               snr: '100000', channel: "'Fading'", diagnostics: '0'}
  states: {state: enabled}
- name: TXOFDM_tx_signal_transmitter_0
  id: TXOFDM_tx_signal_transmitter
  parameters: {case: '0', pickle_directory: "'absent/'",
               pickle_file: "'tx.pckl'"}
  states: {state: enabled}
- name: qtgui_time_sink_x_0
  id: qtgui_time_sink_x
  parameters: {}
  states: {state: bypassed}
- name: blocks_null_sink_0
  id: blocks_null_sink
  parameters: {}
  states: {state: enabled}
connections:
- [TXOFDM_tx_signal_transmitter_0, '0', RXOFDM_synch_and_chan_est_0, '0']
- [RXOFDM_synch_and_chan_est_0, '0', blocks_null_sink_0, '0']
"""


def _xml_block(key, **params):
    ps = "".join(f"<param><key>{k}</key><value>{v}</value></param>"
                 for k, v in params.items())
    return f"<block><key>{key}</key>{ps}</block>"


XML_GRC = ("<?xml version='1.0' encoding='utf-8'?><flow_graph>" +
           _xml_block("options", id="top_block") +
           _xml_block("variable", id="samp_rate", value="960e3") +
           _xml_block("uhd_usrp_source", id="uhd_usrp_source_0",
                      samp_rate="samp_rate", _enabled="True") +
           _xml_block("OFDMReceiver_SynchEstAndFO",
                      id="OFDMReceiver_SynchEstAndFO_0", case="0",
                      fo_range="list([0])", _enabled="True") +
           _xml_block("OFDMReceiver_BitRecovery",
                      id="OFDMReceiver_BitRecovery_0", modulation="'QPSK'",
                      _enabled="True") +
           _xml_block("qtgui_time_sink_x", id="qtgui_time_sink_x_0",
                      _enabled="0") +
           _xml_block("wxgui_fftsink2", id="wxgui_fftsink2_0",
                      _enabled="True") +
           _xml_block("OFDMTransmitter_SimpleTx", id="tx0",
                      _enabled="False") +
           "<connection><source_block_id>uhd_usrp_source_0</source_block_id>"
           "<sink_block_id>OFDMReceiver_SynchEstAndFO_0</sink_block_id>"
           "<source_key>0</source_key><sink_key>0</sink_key></connection>"
           "</flow_graph>")


def write_graphs(directory):
    """The two test graphs (YAML loopback, XML legacy RX) as files."""
    paths = directory / "ofdm_chain.grc", directory / "RxReceiver_Diag.grc"
    paths[0].write_text(YAML_GRC)
    paths[1].write_text(XML_GRC)
    return paths


def test_pickles_cross_read_and_check(tmp_path):
    """A pickle written by either package is read by both, the same."""
    iq = (np.arange(12) * (1 + 2j)).reshape(2, 6).astype(np.complex64)
    io.save_pickle_iq(tmp_path / "a.pckl", iq)
    jio.save_pickle_iq(tmp_path / "b.pckl", iq)
    assert (tmp_path / "a.pckl").read_bytes() == \
        (tmp_path / "b.pckl").read_bytes()
    for name in ("a.pckl", "b.pckl"):
        np.testing.assert_array_equal(io.load_pickle_iq(tmp_path / name), iq)
        np.testing.assert_array_equal(jio.load_pickle_iq(tmp_path / name),
                                      io.load_pickle_iq(tmp_path / name))
        assert io.pickle_check(tmp_path / name) == \
            jio.pickle_check(tmp_path / name)
    # a python2-style pickle (latin1 strings inside)
    with open(tmp_path / "py2.pckl", "wb") as f:
        pickle.dump(iq, f, protocol=2)
    np.testing.assert_array_equal(io.load_pickle_iq(tmp_path / "py2.pckl"),
                                  iq)


def test_golden_npz_and_reference_vectors(tmp_path, monkeypatch):
    """npz round trips both ways; the reference-vector loader reads the
    reference's file layout (made here) as the JAX loader does."""
    arrays = {"x": np.arange(5.0), "y": np.ones((2, 2), np.complex64)}
    io.save_golden_npz(tmp_path / "g.npz", **arrays)
    back = jio.load_golden_npz(tmp_path / "g.npz")
    assert back.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
        np.testing.assert_array_equal(io.load_golden_npz(tmp_path / "g.npz")[k],
                                      arrays[k])
    scen = "chan_type_Fading_SNR_100"
    (tmp_path / "Data").mkdir()
    (tmp_path / "Output").mkdir()
    rng = np.random.default_rng(0)
    for rel in (f"Data/tx_bit_data_{scen}.pckl",
                f"Data/tx_data_online_{scen}.pckl",
                f"Data/tx_data_offline_{scen}.pckl",
                "Output/_output_data.pckl"):
        jio.save_pickle_iq(tmp_path / rel, rng.standard_normal((1, 7)))
    monkeypatch.setattr(jio, "REF_DATA_DIR", tmp_path)
    ours = io.load_reference_vectors(scen, directory=tmp_path)
    ref = jio.load_reference_vectors(scen)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_sources_equal_jax(tmp_path):
    """The three streaming sources give the JAX ones' samples, call by
    call, over wrap-arounds, repeats and file rotation."""
    rng = np.random.default_rng(1)
    for k, n in enumerate((50, 37)):
        jio.save_pickle_iq(tmp_path / f"tx_data_{k}.pckl",
                           (rng.standard_normal((3, n)) +
                            1j * rng.standard_normal((3, n))))
    pairs = [
        (io.TxPickleSource(tmp_path, "tx_data_0.pckl"),
         jio.TxPickleSource(tmp_path, "tx_data_0.pckl")),
        (io.ChunkedPickleSource(tmp_path, "tx_data_", num_files=2,
                                num_repeat=2, max_chunk=16),
         jio.ChunkedPickleSource(tmp_path, "tx_data_", num_files=2,
                                 num_repeat=2, max_chunk=16)),
        (io.TimedPickleSource(tmp_path, "tx_data_1.pckl", calls_per_row=2),
         jio.TimedPickleSource(tmp_path, "tx_data_1.pckl", calls_per_row=2)),
    ]
    for ours, ref in pairs:
        for n in (7, 64, 23, 100, 5, 41, 80):
            a, b = ours(n), ref(n)
            assert a.dtype == b.dtype == np.complex64
            np.testing.assert_array_equal(a, b)


def test_flowgraph_equals_jax_and_drives_a_receiver(tmp_path):
    """The same source through both flowgraphs into CollectSinks; then the
    port's flowgraph with the streaming receiver as its block == the same
    pushes made by hand; a flowgraph with no sink refuses to run."""
    rng = np.random.default_rng(2)
    jio.save_pickle_iq(tmp_path / "tx_data_0.pckl",
                       rng.standard_normal((1, 300)).astype(np.complex64))
    sinks = fg.CollectSink(), jfg.CollectSink()
    fg.Flowgraph(64).connect(io.ChunkedPickleSource(tmp_path, "tx_data_"),
                             sinks[0]).run(7)
    jfg.Flowgraph(64).connect(jio.ChunkedPickleSource(tmp_path, "tx_data_"),
                              sinks[1]).run(7)
    np.testing.assert_array_equal(np.concatenate(sinks[0].items),
                                  np.concatenate(sinks[1].items))

    jcfg = dataclasses.replace(jparams.GOLDEN64, num_ofdm_symb=48).validate()
    cfg = port_cfg(jcfg)
    rx, _ = rx_buffer(jcfg, 0)
    jio.save_pickle_iq(tmp_path / "cap0.pckl", rx[None])
    sink = fg.CollectSink()
    block = rt.ReacqStreamingRx(cfg, 960, device="cpu")
    fg.Flowgraph(960).connect(io.ChunkedPickleSource(tmp_path, "cap",
                                                     max_chunk=960),
                              block.push, sink).run(4)
    by_hand = rt.ReacqStreamingRx(cfg, 960, device="cpu")
    src = io.ChunkedPickleSource(tmp_path, "cap", max_chunk=960)
    for got in sink.items:
        want = by_hand.push(src(960))
        for name in want._fields:
            assert torch.equal(getattr(got, name), getattr(want, name))
    assert sum(int(o.valid.sum()) for o in sink.items) > 0
    fg.NullSink()(sink.items[0])
    with pytest.raises(RuntimeError):
        fg.Flowgraph(8).run(1)


def test_diagnostics_equal_jax(tmp_path):
    """genie compare, EVM, the dumps (same contents, read back) and the IQ
    scatter's arrays; tensors are taken as numpy arrays are."""
    rng = np.random.default_rng(3)
    cir = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    genie = cir + 1e-3 * rng.standard_normal(64)
    ours = diag.genie_channel_compare(64, torch.from_numpy(cir), genie, 2)
    ref = jdiag.genie_channel_compare(64, cir, genie, 2)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    ph = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    pts = np.sign(ph.real) + 1j * np.sign(ph.imag)
    assert diag.evm_db(torch.from_numpy(ph), pts) == jdiag.evm_db(ph, pts)

    llr = rng.standard_normal(16).astype(np.float32)
    hard = (llr > 0).astype(np.int32)
    for mod, d in ((diag, tmp_path / "port"), (jdiag, tmp_path / "jax")):
        d.mkdir()
        paths = [mod.dump_channel_estimate(d, "chan_", cir),
                 mod.dump_soft_bits(d, "soft_", llr, -llr),
                 mod.dump_hard_bits_csv(d, "hard_", hard),
                 mod.dump_mat(d, "mat_", llr=llr)]
        if mod is diag:
            ours_paths = paths
        else:
            ref_paths = paths
    np.testing.assert_array_equal(jio.load_pickle_iq(ours_paths[0]), cir)
    with open(ours_paths[1], "rb") as f, open(ref_paths[1], "rb") as g:
        a, b = pickle.load(f), pickle.load(g)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert ours_paths[2].read_text() == ref_paths[2].read_text()
    assert (ours_paths[3] is None) == (ref_paths[3] is None)
    re, im = diag.iq_scatter(torch.from_numpy(ph),
                             save_to=tmp_path / "scatter.png")
    jre, jim = jdiag.iq_scatter(ph)
    np.testing.assert_array_equal(re, jre)
    np.testing.assert_array_equal(im, jim)


def test_grc_graphs_and_plans_equal_jax(tmp_path):
    """Both formats parse to the same graph, and the same plan (the port's
    notes may word the radio substitution differently, one note each)."""
    for path in write_graphs(tmp_path):
        ours, ref = grc.load_grc(str(path)), jgrc.load_grc(str(path))
        assert ours.fmt == ref.fmt
        assert [dataclasses.asdict(b) for b in ours.blocks] == \
            [dataclasses.asdict(b) for b in ref.blocks]
        assert ours.connections == ref.connections
        assert [b.key for b in ours.enabled_blocks()] == \
            [b.key for b in ref.enabled_blocks()]
        p, q = grc.interpret_grc(ours), jgrc.interpret_grc(ref)
        assert (p.kind, p.source, p.rx, p.sinks) == \
            (q.kind, q.source, q.rx, q.sinks)
        assert dataclasses.asdict(p.config) == dataclasses.asdict(q.config)
        assert p.config_json() == q.config_json()
        assert len(p.notes) == len(q.notes)
        json.dumps(p.config_json())
    plan = grc.interpret_grc(grc.load_grc(str(tmp_path /
                                              "RxReceiver_Diag.grc")))
    assert plan.kind == "legacy_rx" and plan.source["kind"] == "iq_file"
    assert plan.rx["bit_recovery"]["variant"] == "reference"


@pytest.mark.parametrize("expr,env,want", [
    ("'QPSK'", None, "QPSK"), ("[1, 3]", None, [1, 3]),
    ("list([0])", None, [0]), ("fft1/4", {"fft1": 256}, 64),
    ("2**10", None, 1024), ("fft1-2", {"fft1": 256}, 254)])
def test_grc_eval_equals_jax(expr, env, want):
    assert grc._eval(expr, env) == jgrc._eval(expr, env) == want


@pytest.mark.parametrize("expr", ["undefined_var + 1", "9**9**9",
                                  "'a' * 10**9", "__import__('os')"])
def test_grc_eval_refuses(expr):
    with pytest.raises(ValueError):
        grc._eval(expr, {"fft1": 256})
