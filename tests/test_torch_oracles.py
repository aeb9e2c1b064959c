"""The port's numpy oracles (``lte_gnu_radio_code_tpu_torch/reference_cpu/``:
``qam.py``, ``legacy.py``, ``tracker.py``, ``pls.py``) against the JAX
package's on the same seeded numpy inputs, and the oracle group of
``chip_smoke.py`` (``oracle_chain``, ``oracle_legacy``, ``oracle_tracker``,
``oracle_pls``) at test size on the CPU: the port's paths with device
"cpu" against the port's oracles.

Exact (``assert_array_equal``): every output of the four modules, since
they are the same NumPy code.  The group's own gates are the ones it holds
the card to: TX 2e-5, lock / delay / found / counts / pointers / candidate
indices exact, QPSK bits equal but on a decision boundary, QAM bits exact,
LLRs 2e-3, legacy phasors 2e-3, PLS TX 1e-5 and left singular vectors 1e-3;
each gate also fails on an injected fault."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from lte_gnu_radio_code_tpu.reference_cpu import golden as JG
from lte_gnu_radio_code_tpu.reference_cpu import legacy as JL
from lte_gnu_radio_code_tpu.reference_cpu import pls as JP
from lte_gnu_radio_code_tpu.reference_cpu import qam as JQ
from lte_gnu_radio_code_tpu.reference_cpu import tracker as JT
from lte_gnu_radio_code_tpu.utils import params as jparams
from lte_gnu_radio_code_tpu_torch.reference_cpu import legacy as L
from lte_gnu_radio_code_tpu_torch.reference_cpu import pls as P
from lte_gnu_radio_code_tpu_torch.reference_cpu import qam as Q
from lte_gnu_radio_code_tpu_torch.reference_cpu import tracker as T
from lte_gnu_radio_code_tpu_torch.utils import params as tparams
from torch_parity import port_cfg, reduced

CPU = torch.device("cpu")
G64 = reduced(jparams.GOLDEN64, num_ofdm_symb=48)
L1K = reduced(jparams.LTE1024, num_ofdm_symb=16)


def _equal(got, want):
    """Same structure, every array equal."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


def _faded(cfg, seed, snr_db, cfo_hz=0.0):
    """One seeded frame through the JAX package's oracle TX, the Fading
    channel, an optional CFO and AWGN at snr_db: (bits, samples)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, cfg.num_bits)
    tx = JQ.tx_frame(cfg, bits)
    rx = JG.apply_channel(tx, JG.channel_taps("Fading"), max_impulse=cfg.nfft)
    rx = rx * np.exp(1j * 2 * np.pi * cfo_hz / cfg.fs * np.arange(len(rx)))
    nv = np.var(tx) * 10 ** (-snr_db / 10)
    return bits, rx + np.sqrt(nv / 2) * (rng.standard_normal(len(rx)) +
                                         1j * rng.standard_normal(len(rx)))


# -- the four modules == the JAX package's ------------------------------------

@pytest.mark.parametrize("mod", ["QPSK", "QAM16", "QAM64"])
def test_qam_oracle_equals_jax(mod):
    """gray_pam, qam_map, constellation, maxlog_llr, demap_unbias_gain,
    tx_frame, rx_frame and run_chain give the JAX module's arrays."""
    cfg = reduced(jparams.GOLDEN64, num_ofdm_symb=24, modulation=mod,
                  snr_db=20.0)
    pcfg = port_cfg(cfg)
    bps = JQ.BITS_PER_SYMBOL[mod]
    assert Q.BITS_PER_SYMBOL == JQ.BITS_PER_SYMBOL
    for k in range(1, 4):
        _equal(Q.gray_pam(k), JQ.gray_pam(k))
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 512 * bps)
    if mod != "QPSK":
        _equal(Q.qam_map(bits, mod), JQ.qam_map(bits, mod))
    _equal(Q.constellation(mod), JQ.constellation(mod))
    pts = Q.constellation(mod)[0][bits[:512 * bps].reshape(-1, bps)
                                  @ (2 ** np.arange(bps - 1, -1, -1))]
    noisy = pts + 0.1 * (rng.standard_normal(pts.shape) +
                         1j * rng.standard_normal(pts.shape))
    _equal(Q.maxlog_llr(noisy, mod, 0.02), JQ.maxlog_llr(noisy, mod, 0.02))
    h = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    _equal(Q.demap_unbias_gain(h, 10.0), JQ.demap_unbias_gain(h, 10.0))
    frame_bits, rx = _faded(cfg, 4, 20.0)
    _equal(Q.tx_frame(pcfg, frame_bits), JQ.tx_frame(cfg, frame_bits))
    _equal(Q.rx_frame(pcfg, rx), JQ.rx_frame(cfg, rx))
    _equal(Q.run_chain(pcfg, seed=5), JQ.run_chain(cfg, seed=5))


@pytest.mark.parametrize("table,case,cfo_hz", [("CFO_CASES", 7, 1500.0),
                                               ("DSSS_CASES", 9, 0.0)],
                         ids=["cfo7", "dsss9"])
def test_legacy_oracle_equals_jax(table, case, cfo_hz):
    """cfo_bank, dsss_code and rx_frame_cfo (with the despread where the
    case spreads) give the JAX module's arrays, on a Fading buffer with the
    case's CFO candidates and +1500 Hz injected (case 7)."""
    jcfg = jparams.config_from_case(getattr(jparams, table), case)
    pcfg = tparams.config_from_case(getattr(tparams, table), case)
    assert port_cfg(jcfg) == pcfg
    dsss = getattr(jparams, table)[case]["dsss"]
    fo_range = (0.0, -1500.0, 1500.0) if cfo_hz else (0.0,)
    _equal(L.cfo_bank(pcfg.nfft, pcfg.fs, fo_range),
           JL.cfo_bank(jcfg.nfft, jcfg.fs, fo_range))
    for d in (1, 3, 12):
        _equal(L.dsss_code(d), JL.dsss_code(d))
    _, rx = _faded(jcfg, 6, 60.0, cfo_hz)
    got = L.rx_frame_cfo(pcfg, rx, fo_range=fo_range, dsss=dsss, max_det=24)
    want = JL.rx_frame_cfo(jcfg, rx, fo_range=fo_range, dsss=dsss, max_det=24)
    assert want["n_det"] > 0
    _equal(got, want)


@pytest.mark.parametrize("cfg", [G64, L1K], ids=["golden64", "lte1024"])
def test_tracker_oracle_equals_jax(cfg):
    """track_synch and data_demod (the fix and the verbatim rotation, the
    estimated and the genie channel) give the JAX module's arrays."""
    pcfg = port_cfg(cfg)
    _, rx = _faded(cfg, 7, 80.0)
    got, want = T.track_synch(pcfg, rx), JT.track_synch(cfg, rx)
    assert want["n_det"] == cfg.num_patterns
    _equal(got, want)
    h = np.concatenate([JG.channel_taps("Fading"),
                        np.zeros(cfg.nfft - 5, complex)])
    for kw in (dict(fix_rotation=True), dict(fix_rotation=False),
               dict(param_est="Ideal", genie_h=h)):
        _equal(T.data_demod(pcfg, rx, got, **kw),
               JT.data_demod(cfg, rx, want, **kw))


def _unitaries(m, c, seed):
    return m.unitary_gen(c, np.random.default_rng(seed))


def _pls_rx(m, c):
    """A transmitted frame through a seeded dispersive 2x2 channel."""
    tx = m.transmit(c, _unitaries(m, c, 2), m.ref_signal(c))
    h = np.random.default_rng(8).standard_normal((2, 2, 3)) + 0.5j
    return m.mimo_channel(c, tx, h)[:, :c.frame_len]


PLS_CASES = {
    "codebook": lambda m, c: m.codebook(c),
    "zadoff_chu": lambda m, c: [m.zadoff_chu(c, p) for p in (23, 41)],
    "synch_mask": lambda m, c: m.synch_mask(c),
    "ref_signal": lambda m, c: m.ref_signal(c),
    "ref_signal_rng": lambda m, c: m.ref_signal(
        c, legacy_seed=False, rng=np.random.default_rng(1)),
    "unitary_gen": lambda m, c: _unitaries(m, c, 0),
    "bits_to_precoders": lambda m, c: m.bits_to_precoders(
        c, np.array([0, 1, 1, 0, 1, 0, 0, 1])),
    "rotated_precoder": lambda m, c: m.rotated_precoder(
        m.bits_to_precoders(c, np.arange(8) % 3 % 2), _unitaries(m, c, 1)),
    "apply_precoders": lambda m, c: m.apply_precoders(
        c, _unitaries(m, c, 1), m.ref_signal(c)),
    "ofdm_modulate": lambda m, c: [m.ofdm_modulate(c, m.apply_precoders(
        c, _unitaries(m, c, 1), m.ref_signal(c)), norm) for norm in
        ("joint", "legacy")],
    "synch_data_mux_transmit": lambda m, c: [
        m.synch_data_mux(c, np.ones((2, c.num_data_symb * c.symb_len))),
        m.transmit(c, _unitaries(m, c, 2), m.ref_signal(c))],
    "mimo_channel": lambda m, c: [_pls_rx(m, c), m.mimo_channel(
        c, m.transmit(c, _unitaries(m, c, 2), m.ref_signal(c)))],
    "synchronize_channel_estimate": lambda m, c: [
        m.synchronize(c, _pls_rx(m, c)), m.channel_estimate(
            c, m.synchronize(c, _pls_rx(m, c)), m.ref_signal(c))],
    "sv_decomp_pmi": lambda m, c: [
        m.sv_decomp(m.channel_estimate(c, m.synchronize(c, _pls_rx(m, c)),
                                       m.ref_signal(c))),
        m.pmi_estimate(c, _unitaries(m, c, 3))],
    "receive": lambda m, c: m.receive(c, _pls_rx(m, c), m.ref_signal(c)),
    "key_exchange": lambda m, c: [
        m.key_exchange(c, np.array([0, 0, 0, 1, 1, 0, 1, 1]),
                       np.random.default_rng(4), h)
        for h in (None, np.random.default_rng(9).standard_normal((2, 2, 2))
                  + 0.3j)],
}


@pytest.mark.parametrize("name", list(PLS_CASES))
def test_pls_oracle_equals_jax(name):
    """Each public function of the PLS oracle gives the JAX module's arrays
    (the tables, the TX steps, the RX steps, the channel, a whole
    exchange); the port's reference draw leaves the global numpy state
    alone."""
    state = np.random.get_state()
    got = PLS_CASES[name](P, tparams.PLSConfig())
    after = np.random.get_state()
    assert state[0] == after[0] and np.array_equal(state[1], after[1]) \
        and state[2:] == after[2:]
    _equal(got, PLS_CASES[name](JP, jparams.PLSConfig()))


# -- chip_smoke.py's oracle group at test size on the CPU --------------------

def _chain_cfg(name):
    if name == "qam64":
        return dataclasses.replace(chip_smoke.config_of(
            "configs/qam64_sweep.json", None), num_ofdm_symb=48).validate()
    return port_cfg(G64 if name == "golden64" else
                    reduced(jparams.LTE1024, num_ofdm_symb=8))


@pytest.mark.parametrize("name,batch,frames", [("golden64", 4, 2),
                                                ("lte1024", 2, 2),
                                                ("qam64", 4, 4)])
def test_oracle_group_chain(name, batch, frames):
    """chain_batch's halves on the CPU == golden.rx_frame / qam.rx_frame on
    the same buffers (QAM64 at its own 24 dB, where frames carry errors)."""
    cfg = _chain_cfg(name)
    assert chip_smoke.oracle_chain(cfg, batch, frames, CPU, name) > 0


@pytest.mark.parametrize("table,case,fo_range,cfo_hz",
                         [chip_smoke.LEGACY[0], chip_smoke.LEGACY[2]],
                         ids=["cfo7", "dsss9"])
def test_oracle_group_legacy(table, case, fo_range, cfo_hz):
    cases = getattr(tparams, table)
    cfg = tparams.config_from_case(cases, case)
    blocks = 12
    n = blocks * cfg.pattern_len * cfg.rx_b_len
    assert chip_smoke.oracle_legacy(cfg, cases[case]["dsss"], fo_range,
                                    cfo_hz, n + cfg.frame_len, blocks, CPU,
                                    table) > 0


@pytest.mark.parametrize("cfg", [G64, L1K], ids=["golden64", "lte1024"])
def test_oracle_group_tracker(cfg):
    pcfg = port_cfg(cfg)
    xs, _ = chip_smoke.tracker_streams(pcfg, 2, 80.0, CPU)
    assert chip_smoke.oracle_tracker(pcfg, xs, 2, CPU, "tracker") > 0


def test_oracle_group_pls():
    assert chip_smoke.oracle_pls(8, 4, CPU, "PLS") > 0


@pytest.mark.parametrize("fault", ["chain_lock", "chain_bits", "legacy",
                                   "tracker", "pls_tx", "pls_key"])
def test_oracle_group_gate_fails_on_a_fault(monkeypatch, fault):
    """Each gate of the group fails when the port's path is made wrong: a
    lock one sample late, a flipped hard bit, a delay one step off, a
    tracker bit flipped, a TX scaled by 1 + 1e-4, a key bit flipped."""
    from lte_gnu_radio_code_tpu_torch.models import legacy_rx, pls, rxofdm
    from lte_gnu_radio_code_tpu_torch.models import tracker
    from lte_gnu_radio_code_tpu_torch.ops import pls as pls_ops

    def wrap(module, name, change):
        orig = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, **k: change(orig(*a, **k)))

    def flip(t, index):
        t = t.clone()
        t[index] ^= 1
        return t

    if fault.startswith("chain"):
        wrap(rxofdm, "rx_frames_batch", lambda r: r._replace(
            lock_ptr=r.lock_ptr + 1) if fault == "chain_lock" else
            r._replace(hard_bits=flip(r.hard_bits, (1, 7))))
        run = lambda: chip_smoke.oracle_chain(_chain_cfg("golden64"), 2, 2,
                                              CPU, fault)
    elif fault == "legacy":
        orig = legacy_rx.make_legacy_rx
        monkeypatch.setattr(legacy_rx, "make_legacy_rx", lambda *a, **k: (
            lambda x: (lambda r: r._replace(delays=r.delays + 1))(
                orig(*a, **k)(x))))
        cfg = tparams.config_from_case(tparams.DSSS_CASES, 9)
        run = lambda: chip_smoke.oracle_legacy(
            cfg, 12, (0.0,), 0.0, 8 * cfg.frame_len, 6, CPU, fault)
    elif fault == "tracker":
        orig = tracker.make_tracker
        monkeypatch.setattr(tracker, "make_tracker", lambda *a, **k: (
            lambda x: (lambda r: r._replace(hard_bits=flip(
                r.hard_bits, (0, 100))))(orig(*a, **k)(x))))
        pcfg = port_cfg(G64)
        xs, _ = chip_smoke.tracker_streams(pcfg, 1, 80.0, CPU)
        run = lambda: chip_smoke.oracle_tracker(pcfg, xs, 1, CPU, fault)
    else:
        if fault == "pls_tx":
            wrap(pls_ops, "transmit", lambda t: t * (1 + 1e-4))
        else:
            wrap(pls, "key_exchange", lambda r: (flip(r[0], (0, 3)), r[1]))
        run = lambda: chip_smoke.oracle_pls(4, 2, CPU, fault)
    with pytest.raises(AssertionError):
        run()
