"""The legacy CFO/DSSS receivers of the PyTorch port on the CPU, against the
JAX package on numpy inputs made from a seed: the CFO search
(``ops/cfo.py``), the whole-buffer receiver (``models/legacy_rx.py``) and
the streaming one (``runtime/stream.py:LegacyStreamingRx``).

Exact: detection tables (ptrs, delays, fo_idx, count, valid, demod_ok) and
the carry.  Within tolerance: search values and peaks 2e-3, phasors,
despread symbols and channel estimates 2e-4 (the JAX package's own,
tests/test_pallas.py and tests/test_legacy_rx.py).  The K2 launch of the
CUDA branch is recorded instead of made; the kernel is held to its plain
version on a CUDA device by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu.models import legacy_rx as jlegacy
from lte_gnu_radio_code_tpu.ops import cfo as jcfo
from lte_gnu_radio_code_tpu.ops import sync as jsync
from lte_gnu_radio_code_tpu.reference_cpu import golden as G
from lte_gnu_radio_code_tpu.runtime import stream as jrt
from lte_gnu_radio_code_tpu.utils import params as jparams
from lte_gnu_radio_code_tpu_torch import kernels
from lte_gnu_radio_code_tpu_torch.kernels import _cuda
from lte_gnu_radio_code_tpu_torch.models import legacy_rx
from lte_gnu_radio_code_tpu_torch.ops import cfo, sync
from lte_gnu_radio_code_tpu_torch.runtime import stream as rt
from lte_gnu_radio_code_tpu_torch.utils import params as tparams
from torch_parity import port_cfg

ATOL = 2e-4             # phasors, despread symbols, channel estimates
PEAK_ATOL = 2e-3
FO_RANGE = (0.0, -1500.0, 1500.0)
# every case but three: the JAX receiver rejects DSSS case 10 (spreading
# 24 does not divide its 180 bins); at CFO case 4 the +1500 Hz corrector
# does not win the strongest detection, in either package; at CFO case 8
# (nfft 256, phasors of 1.84) the port's phasors differ from the JAX
# package's by up to 3.1e-4 on every demod form it has had (ROADMAP.md)
RX_CASES = ([("CFO_CASES", c) for c in range(10) if c not in (4, 8)] +
            [("DSSS_CASES", c) for c in range(10)])


def _case(table, case):
    return jparams.config_from_case(getattr(jparams, table), case, snr_db=1e8)


def _capture(cfg, seed=0, cfo_hz=0.0, n_frames=1, snr_db=60.0):
    """n_frames replayed TX frames through the Fading channel, an optional
    CFO over the whole stream and a little noise."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n_frames):
        bits = rng.integers(0, 2, cfg.num_bits)
        frames.append(G.apply_channel(G.tx_frame(cfg, bits),
                                      G.channel_taps("Fading"),
                                      max_impulse=cfg.nfft))
    sig = np.concatenate(frames)
    if cfo_hz:
        sig = sig * np.exp(1j * 2 * np.pi * cfo_hz / cfg.fs *
                           np.arange(len(sig)))
    nv = 10 ** (-snr_db / 10)
    sig = sig + np.sqrt(nv / 2) * (rng.standard_normal(len(sig)) +
                                   1j * rng.standard_normal(len(sig)))
    return sig.astype(np.complex64)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_same(a, b, what=""):
    """Two outputs of one NamedTuple layout, from either package: integer
    and bool fields exactly, float fields within tolerance."""
    assert a._fields == b._fields
    for f in a._fields:
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        assert x.shape == y.shape, (what, f, x.shape, y.shape)
        if x.dtype.kind in "fc":
            np.testing.assert_allclose(
                x, y, atol=PEAK_ATOL if f == "peaks" else ATOL, rtol=0,
                err_msg=f"{what} {f}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")


@pytest.mark.parametrize("table,case,cfo_hz", [("CFO_CASES", 0, 1500.0),
                                               ("CFO_CASES", 6, -1500.0),
                                               ("DSSS_CASES", 9, 0.0)])
def test_cfo_search_scan_equals_jax_and_the_cube(table, case, cfo_hz):
    """The running-max scan: value within 2e-3, delay and fo index exact,
    against the JAX scan and against a flat argmax over the materialised
    (trial, fo, delay) cube (first candidate, then first delay, wins ties);
    two buffers at once == each alone."""
    cfg = _case(table, case)
    pcfg = port_cfg(cfg)
    sig = _capture(cfg, seed=case, cfo_hz=cfo_hz)
    n_trials = jsync.n_trials_for(cfg, len(sig))
    bank = cfo.bank_on(pcfg, FO_RANGE, "cpu")
    np.testing.assert_array_equal(bank, jcfo.cfo_bank(cfg, FO_RANGE))
    val, dly, fo = cfo.cfo_search_scan(pcfg, torch.from_numpy(sig), n_trials,
                                       bank)
    jval, jdly, jfo = jcfo.cfo_search_scan(cfg, jnp.asarray(sig), n_trials,
                                           jcfo.cfo_bank(cfg, FO_RANGE))
    assert dly.dtype == fo.dtype == torch.int32 and val.shape == (n_trials,)
    np.testing.assert_allclose(val, np.asarray(jval), atol=PEAK_ATOL, rtol=0)
    np.testing.assert_array_equal(dly, np.asarray(jdly))
    np.testing.assert_array_equal(fo, np.asarray(jfo))
    if cfo_hz:
        strongest = int(val.argmax())
        assert int(fo[strongest]) == FO_RANGE.index(-cfo_hz)

    cube = cfo.sync_correlate_cfo(pcfg, cfo.sync_spectra_cfo(
        pcfg, torch.from_numpy(sig), n_trials, bank)).abs()
    jcube = jnp.abs(jcfo.sync_correlate_cfo(cfg, jcfo.sync_spectra_cfo(
        cfg, jnp.asarray(sig), n_trials, jcfo.cfo_bank(cfg, FO_RANGE))))
    assert cube.shape == (n_trials, 3, cfg.cp_len + 1)
    np.testing.assert_allclose(cube, np.asarray(jcube), atol=PEAK_ATOL,
                               rtol=0)
    flat = cube.reshape(n_trials, -1).argmax(-1)
    torch.testing.assert_close(cube.reshape(n_trials, -1).amax(-1), val,
                               atol=1e-4, rtol=1e-6)
    same = (flat // (cfg.cp_len + 1) == fo) & (flat % (cfg.cp_len + 1) == dly)
    assert int((~same).sum()) <= n_trials // 100      # float ties only

    two = torch.from_numpy(np.stack([sig, sig[::-1].copy()]))
    v2, d2, f2 = cfo.cfo_search_scan(pcfg, two, n_trials, bank)
    assert torch.equal(d2[0], dly) and torch.equal(f2[0], fo)
    torch.testing.assert_close(v2[0], val, atol=1e-4, rtol=1e-6)


def test_cfo_search_first_candidate_wins_a_tie():
    """Two equal candidates tie everywhere: the first keeps every trial, as
    the strict ">" of the scan says."""
    pcfg = port_cfg(_case("CFO_CASES", 0))
    sig = torch.from_numpy(_capture(_case("CFO_CASES", 0)))
    bank = cfo.bank_on(pcfg, (1500.0, 1500.0, 0.0), "cpu")
    _, _, fo = cfo.cfo_search_scan(pcfg, sig, 100, bank)
    assert 1 not in fo.tolist()


def test_dsss_despread_and_tables():
    for dsss in (1, 3, 12, 24):
        np.testing.assert_array_equal(cfo.dsss_code(dsss),
                                      jcfo.dsss_code(dsss))
    dsss = 4
    sc = cfo.dsss_code(dsss)
    syms = np.array([1 + 1j, -1 + 1j, -1 - 1j, 1 - 1j]) / np.sqrt(2)
    chips = (np.kron(syms, np.ones(dsss)) * np.tile(sc, len(syms))).astype(
        np.complex64)
    rec = cfo.dsss_despread(torch.from_numpy(np.stack([chips, -chips])), dsss)
    np.testing.assert_allclose(rec[0], syms, atol=1e-6)
    np.testing.assert_allclose(rec, np.asarray(jcfo.dsss_despread(
        jnp.asarray(np.stack([chips, -chips])), dsss)), atol=1e-6)
    x = torch.from_numpy(chips)
    assert cfo.dsss_despread(x, 1) is x
    bank = torch.arange(12.0).reshape(3, 4)
    sel = torch.tensor([[2, 0], [1, 1]], dtype=torch.int32)
    assert torch.equal(cfo.bank_select(bank, sel), bank[sel.long()])


@pytest.mark.parametrize("table", ["CFO_CASES", "DSSS_CASES"])
def test_case_tables_equal_jax(table):
    ours, theirs = getattr(tparams, table), getattr(jparams, table)
    assert ours == theirs
    for case in ours:
        assert port_cfg(jparams.config_from_case(theirs, case)) == \
            tparams.config_from_case(ours, case)
    assert tparams.config_from_case(ours, 3, snr_db=7.0).snr_db == 7.0


@pytest.mark.parametrize("table,case", RX_CASES)
def test_rx_frame_cfo_equals_jax(table, case):
    """The whole-buffer receiver: the detection table exact, phasors,
    despread symbols and channels within 2e-4, peaks 2e-3, over the case
    tables; the CFO cases with +1500 Hz injected and three candidates."""
    cfg = _case(table, case)
    is_cfo = table == "CFO_CASES"
    dsss = getattr(jparams, table)[case]["dsss"]
    fo_range = FO_RANGE if is_cfo else (0.0,)
    sig = _capture(cfg, seed=case, cfo_hz=1500.0 if is_cfo else 0.0,
                   n_frames=2)
    ref = jlegacy.make_legacy_rx(cfg, len(sig), fo_range=fo_range, dsss=dsss,
                                 max_det=48)(jnp.asarray(sig))
    r = legacy_rx.make_legacy_rx(port_cfg(cfg), len(sig), fo_range=fo_range,
                                 dsss=dsss, max_det=48, device="cpu")(sig)
    n = int(ref.count)
    assert n >= 2 * cfg.num_patterns - 1 and r.ptrs.dtype == torch.int32
    assert r.despread.shape == (48, cfg.num_data_bins // dsss)
    _assert_same(r, ref, f"{table} {case}")
    if is_cfo:
        best = int(r.peaks[:n].argmax())
        assert int(r.fo_idx[best]) == 1       # the -1500 Hz corrector


def test_rx_frame_cfo_takes_a_batch_of_buffers():
    cfg = _case("DSSS_CASES", 4)
    pcfg = port_cfg(cfg)
    sigs = np.stack([_capture(cfg, seed=s) for s in (1, 2)])
    n_trials = sync.n_trials_for(pcfg, sigs.shape[1])
    both = legacy_rx.rx_frame_cfo(pcfg, torch.from_numpy(sigs), n_trials,
                                  dsss=2, max_det=24)
    assert both.ptrs.shape == (2, 24) and both.count.shape == (2,)
    for r in range(2):
        one = legacy_rx.rx_frame_cfo(pcfg, torch.from_numpy(sigs[r]),
                                     n_trials, dsss=2, max_det=24)
        _assert_same(type(both)(*(f[r] for f in both)), one, f"row {r}")


def _padded(sig, chunk):
    buf = np.zeros(-(-len(sig) // chunk) * chunk, np.complex64)
    buf[:len(sig)] = sig
    return buf.reshape(-1, chunk), [max(0, min(chunk, len(sig) - i))
                                    for i in range(0, len(buf), chunk)]


def _drive(rx, sig, chunk):
    chunks, n_reals = _padded(sig, chunk)
    return [rx.push(c, n_real=n) for c, n in zip(chunks, n_reals)] + \
        list(rx.finish())


def _valid(outs, field):
    return np.concatenate([_np(getattr(o, field))[_np(o.valid)]
                           for o in outs])


@pytest.mark.parametrize("table,case,strides", [("CFO_CASES", 0, 40),
                                                ("CFO_CASES", 0, 96),
                                                ("DSSS_CASES", 4, 40),
                                                ("DSSS_CASES", 4, 96)])
def test_legacy_stream_equals_batch_and_jax(table, case, strides):
    """Chunk by chunk == the JAX receiver (every field of every chunk, and
    the carry), and == the whole-buffer receiver on its trial range, at two
    chunk lengths, on the K2 path's CPU twin."""
    cfg = _case(table, case)
    pcfg = port_cfg(cfg)
    is_cfo = table == "CFO_CASES"
    dsss = getattr(jparams, table)[case]["dsss"]
    fo_range = FO_RANGE if is_cfo else (0.0,)
    sig = _capture(cfg, seed=case, cfo_hz=1500.0 if is_cfo else 0.0,
                   n_frames=3)
    chunk = cfg.stride * strides
    jouts = _drive(jrt.LegacyStreamingRx(cfg, chunk, fo_range=fo_range,
                                         dsss=dsss), sig, chunk)
    srx = rt.LegacyStreamingRx(pcfg, chunk, fo_range=fo_range, dsss=dsss,
                               device="cpu")
    assert srx.det_max == rt.reacq_det_max(pcfg, chunk)
    assert srx.lag == rt.legacy_lag(pcfg) == jrt.legacy_lag(cfg)
    outs = _drive(srx, sig, chunk)
    assert len(outs) == len(jouts)
    for i, (o, jo) in enumerate(zip(outs, jouts)):
        _assert_same(o, jo, f"chunk {i}")
    jstate = jrt.LegacyStreamingRx(cfg, chunk, fo_range=fo_range, dsss=dsss)
    _drive(jstate, sig, chunk)
    for f, v in srx.state._asdict().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jstate.state, f)),
                                      err_msg=f)

    batch = legacy_rx.make_legacy_rx(pcfg, len(sig), fo_range=fo_range,
                                     dsss=dsss, max_det=128, device="cpu")(sig)
    nb = int(batch.count)
    ptrs = _valid(outs, "ptrs")
    keep = ptrs <= int(batch.ptrs[:nb].max())     # the flush probes further
    assert nb >= 3 * cfg.num_patterns - 1
    np.testing.assert_array_equal(ptrs[keep], batch.ptrs[:nb])
    np.testing.assert_array_equal(_valid(outs, "delays")[keep],
                                  batch.delays[:nb])
    np.testing.assert_array_equal(_valid(outs, "fo_idx")[keep],
                                  batch.fo_idx[:nb])
    assert _valid(outs, "demod_ok")[keep].all()
    np.testing.assert_allclose(_valid(outs, "phasors")[keep],
                               batch.phasors[:nb], atol=2e-5, rtol=0)
    np.testing.assert_allclose(_valid(outs, "despread")[keep],
                               batch.despread[:nb], atol=2e-5, rtol=0)


def test_legacy_push_many_equals_pushes_and_jax():
    cfg = _case("CFO_CASES", 0)
    pcfg = port_cfg(cfg)
    chunk = cfg.stride * 40
    sig = _capture(cfg, seed=3, cfo_hz=1500.0, n_frames=3)
    chunks = sig[:len(sig) // chunk * chunk].reshape(-1, chunk)[:8]
    a = rt.LegacyStreamingRx(pcfg, chunk, fo_range=FO_RANGE, device="cpu")
    b = rt.LegacyStreamingRx(pcfg, chunk, fo_range=FO_RANGE, device="cpu")
    j = jrt.LegacyStreamingRx(cfg, chunk, fo_range=FO_RANGE)
    seq = [a.push(c) for c in chunks]
    for g in (0, 4):
        many = b.push_many(chunks[g:g + 4])
        assert isinstance(many, rt.LegacyChunkOut)
        for f in many._fields:
            assert torch.equal(getattr(many, f), torch.stack(
                [getattr(o, f) for o in seq[g:g + 4]])), f
        _assert_same(many, j.push_many(chunks[g:g + 4]), f"group {g}")
    for f, v in a.state._asdict().items():
        assert torch.equal(v, getattr(b.state, f)), f
    assert int(many.valid.sum()) > 0
    with pytest.raises(ValueError):
        b.push(chunks[0][:100])
    with pytest.raises(ValueError, match="stride"):
        rt.LegacyStreamingRx(pcfg, chunk + 1, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_legacy_checkpoint_crosses_the_packages(tmp_path, writer):
    """A checkpoint written after 5 chunks by either package resumes in the
    other (and in its own) to the uninterrupted run's outputs."""
    cfg = _case("DSSS_CASES", 4)
    pcfg = port_cfg(cfg)
    chunk = cfg.stride * 40
    sig = _capture(cfg, seed=4, n_frames=3)
    chunks, n_reals = _padded(sig, chunk)
    kw = dict(dsss=2)

    def run(rx_, start):
        return [rx_.push(c, n_real=n) for c, n in
                zip(chunks[start:], n_reals[start:])] + list(rx_.finish())

    full = run(rt.LegacyStreamingRx(pcfg, chunk, device="cpu", **kw), 0)
    jfull = run(jrt.LegacyStreamingRx(cfg, chunk, **kw), 0)
    w = (jrt.LegacyStreamingRx(cfg, chunk, **kw) if writer == "jax"
         else rt.LegacyStreamingRx(pcfg, chunk, device="cpu", **kw))
    for c, n in zip(chunks[:5], n_reals[:5]):
        w.push(c, n_real=n)
    w.save_state(tmp_path / "st.npz")
    with np.load(tmp_path / "st.npz") as z:
        assert sorted(z.files) == ["any_det", "base", "hist_im", "hist_re",
                                   "last_det_ptr", "real_end"]
    resumed = rt.LegacyStreamingRx(pcfg, chunk, device="cpu", **kw)
    resumed.load_state(tmp_path / "st.npz")
    assert isinstance(resumed.state, rt.LegacyStreamState)
    jresumed = jrt.LegacyStreamingRx(cfg, chunk, **kw)
    jresumed.load_state(tmp_path / "st.npz")
    for o, ref in zip(run(resumed, 5), full[5:]):
        _assert_same(o, ref, f"port resumes {writer}'s")
    for o, ref in zip(run(jresumed, 5), jfull[5:]):
        _assert_same(o, ref, f"jax resumes {writer}'s")
    assert len(_valid(full[5:], "ptrs")) > 3


@pytest.mark.parametrize("make", [
    lambda **kw: rt.LegacyStreamingRx(port_cfg(_case("CFO_CASES", 0)), 600,
                                      **kw),
    lambda **kw: legacy_rx.make_legacy_rx(port_cfg(_case("CFO_CASES", 0)),
                                          4000, **kw)],
    ids=["stream", "whole-buffer"])
def test_legacy_entry_points_run_on_the_card_unless_asked(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(**kw)
    make(device="cpu")


def test_legacy_step_hands_k2_one_row_a_detection(monkeypatch):
    """The CUDA branch of a chunk step, the launch recorded instead of
    made: the search launches nothing (it is plain torch), the demod is one
    K2 launch over [det_max, nfft] contiguous windows with one coefficient
    row a window; the history is a copy."""
    calls = []
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "launch",
                        lambda name, dev, *args: calls.append((name, args)))
    cfg = _case("DSSS_CASES", 4)
    pcfg = port_cfg(cfg)
    chunk = cfg.stride * 40
    rx = rt.LegacyStreamingRx(pcfg, chunk, dsss=2, device="cpu")
    kernels.reset_launch_counts()
    sig = _capture(cfg, seed=5)
    rx.push_many(sig[:2 * chunk].reshape(2, chunk))
    assert [name for name, _ in calls] == ["equalize_fft"] * 2
    args = calls[0][1]
    assert len(args) + 1 == len(_cuda.SIGNATURES["equalize_fft"])
    assert args[4] == cfg.num_data_bins            # one coeff row a window
    assert args[6:9] == (rx.det_max, cfg.nfft, cfg.num_data_bins)
    counts = kernels.launch_counts()
    assert counts["equalize"] == 2 and counts["sync_search"] == 0
    assert rx.state.hist.is_contiguous() and rx.state.hist._base is None
    kernels.reset_launch_counts()
