"""The serving path of the PyTorch port on the CPU, against the JAX package
on numpy inputs made from a seed: the refractory selection, the
multi-detection RX (``models/stream_rx.py``) and the streaming receivers
(``runtime/stream.py``).

Exact: detection tables (ptrs, delays, count, valid, demod_ok), hard bits,
block ids, lock flags and pointers.  Within tolerance: phasors and channel
estimates 2e-4, peaks 2e-3 (the JAX package's own, tests/test_pallas.py and
tests/test_stream_rx.py).  The wrappers' CUDA branches run with the launch
recorded instead of made; on the CPU every wrapper runs its kernel's plain
twin, and the kernels themselves are held to those twins on a CUDA device
by tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lte_gnu_radio_code_tpu.models import stream_rx as jstream_rx
from lte_gnu_radio_code_tpu.ops import sync as jsync
from lte_gnu_radio_code_tpu.reference_cpu import golden
from lte_gnu_radio_code_tpu.runtime import stream as jrt
from lte_gnu_radio_code_tpu.utils.params import GOLDEN64, OFDMConfig
from lte_gnu_radio_code_tpu_torch import kernels
from lte_gnu_radio_code_tpu_torch.kernels import _cuda
from lte_gnu_radio_code_tpu_torch.models import stream_rx
from lte_gnu_radio_code_tpu_torch.ops import sync
from lte_gnu_radio_code_tpu_torch.parallel import mesh as pmesh
from lte_gnu_radio_code_tpu_torch.parallel import streaming
from lte_gnu_radio_code_tpu_torch.runtime import stream as rt
from lte_gnu_radio_code_tpu_torch.utils import profiling
from torch_parity import port_cfg, recorded_launch, reduced

CFG = GOLDEN64
PCFG = port_cfg(CFG)
# refractory 24 samples; stride 1 (jump 25 trials) and stride 5 (jump 5)
TINY = dict(nfft=16, cp_len=4, num_synch_bins=14, num_data_bins=12,
            num_ofdm_symb=8)
T1 = reduced(CFG, **TINY)
T5 = reduced(CFG, stride=5, **TINY)
# a strided configuration below LTE size: 4 frames' worth of trials a chunk
S31 = reduced(CFG, nfft=128, cp_len=32, num_synch_bins=126,
              num_data_bins=120, num_ofdm_symb=24, stride=31)
ATOL = 2e-4             # phasors, channel estimates
PEAK_ATOL = 2e-3


def _tx(cfg, seed):
    bits = np.random.default_rng(seed).integers(0, 2, cfg.num_bits)
    return bits, golden.tx_frame(cfg, bits)


def _faded(cfg, seed):
    bits, tx = _tx(cfg, seed)
    rx = golden.apply_channel(tx, golden.channel_taps("Fading"))
    return bits, rx.astype(np.complex64)


@pytest.fixture(scope="module")
def faded():
    return _faded(CFG, 0)


@pytest.fixture(scope="module")
def jax_batch(faded):
    """The JAX package's whole-buffer detections of the faded frame."""
    _, rx = faded
    return jstream_rx.make_rx_detections(CFG, len(rx))(jnp.asarray(rx))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_same(a, b, what=""):
    """Two outputs of the same NamedTuple layout, from either package:
    integer and bool fields exactly, float fields within tolerance."""
    for f in a._fields:
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        assert x.shape == y.shape, (what, f, x.shape, y.shape)
        if x.dtype.kind in "fc":
            np.testing.assert_allclose(
                x, y, atol=PEAK_ATOL if f == "peaks" else ATOL, rtol=0,
                err_msg=f"{what} {f}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")


def _padded(sig, chunk):
    buf = np.zeros(-(-len(sig) // chunk) * chunk, np.complex64)
    buf[:len(sig)] = sig
    return buf, [max(0, min(chunk, len(sig) - i))
                 for i in range(0, len(buf), chunk)]


def _drive(rx, sig, chunk):
    """Push sig chunk by chunk with its real lengths, then flush."""
    buf, n_reals = _padded(sig, chunk)
    outs = [rx.push(buf[i * chunk:(i + 1) * chunk], n_real=n)
            for i, n in enumerate(n_reals)]
    return outs + list(rx.finish())


def _valid(outs, field):
    return np.concatenate([_np(getattr(o, field))[_np(o.valid)]
                           for o in outs])


# ---------------------------------------------------------------------------
# the refractory selection
# ---------------------------------------------------------------------------

def _masks(seed, rows, p, density):
    return np.random.default_rng(seed).random((rows, p)) < density


CARRIES = {                     # (last_ptr, any_yet) relative to base_ptr
    "none": None,
    "idx_start<0": (-900, True),         # early chunks: far behind the base
    "inside": (57, True),
    "not-yet": (57, False),              # a pointer without a detection
    "past-the-end": (5000, True),
}


@pytest.mark.parametrize("cfg", [T1, T5], ids=["stride1", "stride5"])
@pytest.mark.parametrize("carry", list(CARRIES))
@pytest.mark.parametrize("density", [0.02, 0.3, 1.0])
def test_refractory_table_equals_scan_and_jax(cfg, carry, density):
    """refractory_table == refractory_scan + emit_slots (the sequential
    oracle) == the JAX package's, on seeded crossing masks, for a batch of
    rows at once and row by row."""
    pcfg = port_cfg(cfg)
    p, base = 300, 1000
    stride = cfg.stride
    max_det = p * stride // (2 * cfg.cp_len + cfg.nfft) + 1
    cross = _masks(10 * stride + list(CARRIES).index(carry), 4, p, density)
    ptrs = base + stride * np.arange(p)
    extra = np.random.default_rng(1).standard_normal((4, p)).astype(
        np.float32)
    kw, jkw = {}, {}
    if CARRIES[carry] is not None:
        last, any_yet = CARRIES[carry]
        kw = dict(last_ptr=torch.full((4,), base + last, dtype=torch.int32),
                  any_yet=torch.full((4,), any_yet))
        jkw = dict(last_ptr=jnp.int32(base + last),
                   any_yet=jnp.bool_(any_yet))
    tc, tp, te = map(torch.from_numpy, (cross, ptrs, extra))
    t_ptrs, (t_e, t_i), t_count, (t_last, t_any) = sync.refractory_table(
        pcfg, tc, (te, torch.arange(p)), max_det, base, **kw)
    assert t_ptrs.dtype == t_count.dtype == t_last.dtype == torch.int32

    acc, (s_last, s_any) = sync.refractory_scan(pcfg, tc, tp, **kw)
    (s_ptrs, s_e), s_count = sync.emit_slots(acc, (tp, te), max_det)
    ok = torch.arange(max_det) < s_count[:, None]
    np.testing.assert_array_equal(t_count, s_count)
    np.testing.assert_array_equal(t_ptrs, torch.where(ok, s_ptrs, -1))
    np.testing.assert_array_equal(t_e, s_e)
    np.testing.assert_array_equal(t_any, s_any)
    # the scan's carry keeps a pointer it was given; the table's too
    np.testing.assert_array_equal(t_last, s_last)

    for r in range(4):
        j_ptrs, (j_e, j_i), j_count, (j_last, j_any) = jsync.refractory_table(
            cfg, jnp.asarray(cross[r]), (jnp.asarray(extra[r]),
                                         jnp.arange(p)), max_det, base, **jkw)
        np.testing.assert_array_equal(t_ptrs[r], np.asarray(j_ptrs))
        np.testing.assert_array_equal(t_e[r], np.asarray(j_e))
        np.testing.assert_array_equal(t_i[r], np.asarray(j_i))
        assert int(t_count[r]) == int(j_count)
        assert (int(t_last[r]), bool(t_any[r])) == (int(j_last), bool(j_any))
        j_acc, (js_last, js_any) = jsync.refractory_scan(
            cfg, jnp.asarray(cross[r]), jnp.asarray(ptrs), **jkw)
        np.testing.assert_array_equal(acc[r], np.asarray(j_acc))
        assert (int(s_last[r]), bool(s_any[r])) == (int(js_last),
                                                    bool(js_any))
        # one row alone gives what it gives inside the batch
        one = sync.refractory_table(
            pcfg, tc[r], (te[r],), max_det, base,
            **{k: v[r] for k, v in kw.items()})
        np.testing.assert_array_equal(one[0], t_ptrs[r])


@pytest.mark.parametrize("offset,first", [(-1, 0), (0, 1), (4, 1), (5, 2)])
def test_idx_start_is_floored_at_stride_5(offset, first):
    """idx_start = (last + refractory - base) // stride + 1 with the floor of
    a negative numerator (-1 // 5 = -1, so trial 0 is open), where a
    division that truncates would close trial 0."""
    pcfg = port_cfg(T5)
    refractory = 2 * T5.cp_len + T5.nfft
    base = 500
    last = base - refractory + offset        # numerator == offset
    cross = torch.ones(40, dtype=torch.bool)
    ptrs, _, count, _ = sync.refractory_table(
        pcfg, cross, (), 9, base, last_ptr=torch.tensor(last),
        any_yet=torch.tensor(True))
    assert int(ptrs[0]) == base + 5 * first
    acc, _ = sync.refractory_scan(pcfg, cross, base + 5 * torch.arange(40),
                                  last_ptr=last, any_yet=True)
    assert int(acc.to(torch.int32).argmax()) == first
    assert int(count) == int(acc.sum())
    j = jsync.refractory_table(T5, jnp.ones(40, bool), (), 9, base,
                               jnp.int32(last), jnp.bool_(True))
    np.testing.assert_array_equal(ptrs, np.asarray(j[0]))


def test_refractory_select_idx_and_emit_slots_equal_jax():
    for cfg in (T1, T5):
        pcfg = port_cfg(cfg)
        cross = _masks(7, 1, 200, 0.2)[0]
        for start in (-3, 0, 17, 199, 260):
            idxs, oks = sync.refractory_select_idx(
                pcfg, torch.from_numpy(cross), 12, start)
            j_idxs, j_oks = jsync.refractory_select_idx(
                cfg, jnp.asarray(cross), 12, start)
            np.testing.assert_array_equal(idxs, np.asarray(j_idxs))
            np.testing.assert_array_equal(oks, np.asarray(j_oks))
    src = np.arange(200, dtype=np.int32) * 3
    for max_det in (5, 60):               # overflow dropped; room to spare
        (out,), count = sync.emit_slots(torch.from_numpy(cross),
                                        (torch.from_numpy(src),), max_det)
        (j_out,), j_count = jsync.emit_slots(jnp.asarray(cross),
                                             (jnp.asarray(src),), max_det)
        np.testing.assert_array_equal(out, np.asarray(j_out))
        assert int(count) == int(j_count)


def test_table_overflow():
    """Without a carry the table drops what is beyond max_det, as the JAX
    package's; with a carry a table that could overflow is refused."""
    pcfg = port_cfg(T1)
    cross = torch.ones(300, dtype=torch.bool)
    ptrs, _, count, _ = sync.refractory_table(pcfg, cross, (), 3, 4)
    j = jsync.refractory_table(T1, jnp.ones(300, bool), (), 3, 4)
    np.testing.assert_array_equal(ptrs, np.asarray(j[0]))
    assert int(count) == int(j[2]) == 3
    with pytest.raises(ValueError, match="can overflow"):
        sync.refractory_table(pcfg, cross, (), 12, 4, last_ptr=0,
                              any_yet=False)
    with pytest.raises(AssertionError):
        jsync.refractory_table(T1, jnp.ones(300, bool), (), 12, 4,
                               jnp.int32(0), jnp.bool_(False))
    sync.refractory_table(pcfg, cross, (), 13, 4, last_ptr=0, any_yet=False)


def test_refractory_detect_equals_jax():
    rng = np.random.default_rng(3)
    peaks = (rng.random((2, 500)) * 70).astype(np.float32)
    gate = np.float32(CFG.detection_gate * CFG.num_synch_bins)
    peaks[0, 10], peaks[0, 11] = gate, np.nextafter(gate, np.float32(99))
    idx = np.arange(500, dtype=np.int32)
    ptrs, (e,), count = sync.refractory_detect(
        PCFG, torch.from_numpy(peaks), (torch.from_numpy(idx),), 100)
    for r in range(2):
        j_ptrs, (j_e,), j_count = jsync.refractory_detect(
            CFG, jnp.asarray(peaks[r]), (jnp.asarray(idx),), 100)
        np.testing.assert_array_equal(ptrs[r], np.asarray(j_ptrs))
        np.testing.assert_array_equal(e[r], np.asarray(j_e))
        assert int(count[r]) == int(j_count)
    # the gate is a strict float32 comparison: trial 10 sits on it
    assert CFG.cp_len + 10 not in ptrs[0].tolist()


def test_hard_decide_on_both_sides_of_both_thresholds():
    f32 = np.float32
    k2 = f32(np.sqrt(2.0))
    vals = np.array([0.0, -0.0, 1e-30, -1e-30, 0.5, -0.5, 0.70710677,
                     -0.70710677, np.nextafter(k2, f32(0)), k2,
                     np.nextafter(k2, f32(9)), 1.4142137, 1.5, -1.5,
                     -np.nextafter(k2, f32(0)), -k2,
                     -np.nextafter(k2, f32(9)), 2.0, -2.0], f32)
    ph = (vals[:, None] + 1j * vals[None, :]).astype(np.complex64)
    hard = stream_rx.hard_decide(PCFG, torch.from_numpy(ph))
    ref = np.asarray(jstream_rx.hard_decide(CFG, jnp.asarray(ph)))
    assert hard.dtype == torch.int32 and hard.shape == (len(vals),
                                                        2 * len(vals))
    np.testing.assert_array_equal(hard, ref)
    real_rail = dict(zip(vals.tolist(), hard[:, 0].tolist()))
    assert real_rail[0.5] == 0 and real_rail[-0.5] == 1
    assert real_rail[1.5] == 1 and real_rail[-1.5] == 0     # the overshoot
    for mod in ("QAM16", "QAM64"):      # the max-log decision, any shape
        qcfg = reduced(CFG, modulation=mod)
        q = stream_rx.hard_decide(port_cfg(qcfg), torch.from_numpy(ph))
        assert q.shape == (len(vals), len(vals) * qcfg.bits_per_bin)
        np.testing.assert_array_equal(
            q, np.asarray(jstream_rx.hard_decide(qcfg, jnp.asarray(ph))))


# ---------------------------------------------------------------------------
# whole-buffer multi-detection RX
# ---------------------------------------------------------------------------

# the JAX package's searches: None / "ifft" (trial FFTs and one inverse
# FFT each), False (the dense delay product), True (the conv bank) and
# "pallas" (its K4); and its demods: None (jnp.fft) and "dft"
JAX_SEARCHES = [None, "ifft", False, True, "pallas"]


@pytest.fixture(scope="module")
def port_batch(faded):
    _, rx = faded
    return stream_rx.make_rx_detections(PCFG, len(rx))(torch.from_numpy(rx))


@pytest.mark.parametrize("jdemod", [None, "dft"])
@pytest.mark.parametrize("jfast", JAX_SEARCHES, ids=str)
def test_rx_detections_equals_jax(faded, port_batch, jfast, jdemod):
    """The port's one path (on the CPU K4's and K2's twins) gives each of
    the JAX package's search and demod forms' 60 detections of the faded
    GOLDEN64 frame, its hard bits (== the sent bits) exactly and its
    phasors and channel estimates within 2e-4."""
    bits, rx = faded
    r = port_batch
    j = jstream_rx.make_rx_detections(CFG, len(rx), fast=jfast,
                                      demod_path=jdemod)(jnp.asarray(rx))
    assert int(r.count) == 60 and r.ptrs.dtype == r.delays.dtype == \
        torch.int32
    _assert_same(r, j, f"{jfast}/{jdemod}")
    sent = _np(r.hard_bits)[:60].ravel()
    np.testing.assert_array_equal(sent, bits[:sent.size])


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 6])
def test_rx_detections_equals_jax_on_more_frames(seed):
    """Other faded GOLDEN64 frames: the port's detections == the JAX
    package's, its hard bits the sent bits."""
    bits, rx = _faded(CFG, seed)
    r = stream_rx.make_rx_detections(PCFG, len(rx))(torch.from_numpy(rx))
    _assert_same(r, jstream_rx.make_rx_detections(CFG, len(rx))(
        jnp.asarray(rx)), f"seed {seed}")
    n = int(r.count)
    assert n == 60
    sent = _np(r.hard_bits)[:n].ravel()
    np.testing.assert_array_equal(sent, bits[:sent.size])


def test_rx_detections_jax_conv_dft_and_a_batch_of_buffers(faded):
    """The JAX package's own fast search and DFT demod against the port's,
    and two buffers at once against each alone."""
    _, rx = faded
    _, rx2 = _faded(CFG, 5)
    j = jstream_rx.make_rx_detections(CFG, len(rx), fast=True,
                                      demod_path="dft")(jnp.asarray(rx))
    both = stream_rx.make_rx_detections(PCFG, len(rx))(
        torch.from_numpy(np.stack([rx, rx2])))
    assert both.ptrs.shape == (2, 100) and both.count.shape == (2,)
    _assert_same(type(both)(*(f[0] for f in both)), j, "conv/dft")
    one = stream_rx.make_rx_detections(PCFG, len(rx))(
        torch.from_numpy(rx2))
    _assert_same(type(both)(*(f[1] for f in both)), one, "row 1")


def test_unknown_selectors_raise(faded):
    _, rx = faded
    x = torch.from_numpy(rx[:2000])
    q = stream_rx.rx_detections(port_cfg(reduced(CFG, modulation="QAM16")),
                                x, 100)
    assert q.hard_bits.shape == (100, 3, 60 * 4) and int(q.count) > 0


# ---------------------------------------------------------------------------
# the continuous multi-detection stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [960, 1504, 4800])
def test_reacq_stream_equals_batch_and_jax(faded, jax_batch, chunk):
    """Chunked streaming == the whole-buffer batch on the batch's trial
    range, for any chunking, and == the JAX receiver chunk by chunk."""
    bits, rx = faded
    srx = rt.ReacqStreamingRx(PCFG, chunk, device="cpu")
    jrx = jrt.ReacqStreamingRx(CFG, chunk)
    assert srx.det_max == jrx.det_max == rt.reacq_det_max(PCFG, chunk)
    outs, jouts = _drive(srx, rx, chunk), _drive(jrx, rx, chunk)
    assert len(outs) == len(jouts)
    for i, (o, jo) in enumerate(zip(outs, jouts)):
        _assert_same(o, jo, f"chunk {i}")
    for f, v in srx.state._asdict().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jrx.state, f)),
                                      err_msg=f)

    batch = stream_rx.make_rx_detections(PCFG, len(rx))(torch.from_numpy(rx))
    nb = int(batch.count)
    ptrs = _valid(outs, "ptrs")
    keep = ptrs <= int(batch.ptrs[:nb].max())   # the flush probes further
    np.testing.assert_array_equal(ptrs[keep], batch.ptrs[:nb])
    np.testing.assert_array_equal(_valid(outs, "delays")[keep],
                                  batch.delays[:nb])
    assert _valid(outs, "demod_ok")[keep].all()
    np.testing.assert_array_equal(_valid(outs, "hard_bits")[keep],
                                  batch.hard_bits[:nb])
    np.testing.assert_allclose(_valid(outs, "phasors")[keep],
                               batch.phasors[:nb], atol=2e-5, rtol=0)
    np.testing.assert_array_equal(
        _valid(outs, "hard_bits")[keep].ravel(), bits)


@pytest.mark.parametrize("mod,snr_db", [("QAM16", 100.0), ("QAM16", 18.0)])
def test_reacq_stream_serves_qam(mod, snr_db):
    """The continuous receiver on a QAM16 stream with no change of its own:
    chunk by chunk == the JAX receiver (tables and hard bits exact, the
    unbiased phasors within 2e-4), on the kernels' CPU twins; at 100 dB the
    hard bits are the sent bits."""
    from torch_parity import (assert_bits_equal_or_on_boundary,
                              jax_rx_buffer)
    cfg = reduced(CFG, modulation=mod, num_ofdm_symb=120, snr_db=snr_db)
    pcfg = port_cfg(cfg)
    rx, bits = jax_rx_buffer(cfg, 31, None if snr_db == 100.0 else snr_db)
    chunk = 960
    jouts = _drive(jrt.ReacqStreamingRx(cfg, chunk), rx, chunk)
    outs = _drive(rt.ReacqStreamingRx(pcfg, chunk, device="cpu"), rx, chunk)
    for i, (o, jo) in enumerate(zip(outs, jouts)):
        skip = type(o)(*(getattr(jo, f) if f == "hard_bits"
                         else getattr(o, f) for f in o._fields))
        _assert_same(skip, jo, f"chunk {i}")
        assert_bits_equal_or_on_boundary(o.hard_bits, jo.hard_bits,
                                         jo.phasors, cfg, ATOL)
        hard = _valid(outs, "hard_bits")
        assert hard.shape == (cfg.num_patterns, 3, 60 * cfg.bits_per_bin)
        if snr_db == 100.0:
            np.testing.assert_array_equal(hard.ravel(), bits)
        else:
            assert 0 < (hard.ravel() != bits).sum() < 0.1 * bits.size


def test_reacq_drift_and_channel_change():
    """30 frames' blocks over Fading, a timing slip of 37 samples, 30 over
    another channel: every block re-detected and its channel refreshed;
    pointers and bits == the numpy oracle's == the sent bits."""
    half = OFDMConfig(num_ofdm_symb=120).validate()
    bits1, tx1 = _tx(half, 1)
    bits2, tx2 = _tx(half, 2)
    h2 = np.array([0.9, 0.2 - 0.1j, 0.05j])
    sig = np.concatenate([
        golden.apply_channel(tx1, golden.channel_taps("Fading")),
        np.zeros(37, complex),
        golden.apply_channel(tx2, h2 / np.linalg.norm(h2))])
    o = golden.rx_stream(half, sig, max_det=100)
    assert len(o["ptrs"]) == 60
    outs = _drive(rt.ReacqStreamingRx(port_cfg(half), 960, device="cpu"),
                  sig, 960)
    np.testing.assert_array_equal(_valid(outs, "ptrs"), o["ptrs"])
    hard = _valid(outs, "hard_bits").ravel()
    oh, _, _ = golden.bit_recovery(
        o["phasors"].reshape(-1, half.num_data_bins))
    np.testing.assert_array_equal(hard, oh)
    np.testing.assert_array_equal(hard, np.concatenate([bits1, bits2]))
    np.testing.assert_allclose(_valid(outs, "phasors"), o["phasors"],
                               atol=ATOL, rtol=0)


def _chunks_of(sig, chunk):
    n = len(sig) // chunk * chunk
    return np.asarray(sig[:n], np.complex64).reshape(-1, chunk)


def test_push_many_equals_sequential(faded):
    """push_many == K push calls exactly, outputs and carry; and == the JAX
    receiver's push_many."""
    _, rx = faded
    chunks = _chunks_of(rx, 960)[:12]
    a = rt.ReacqStreamingRx(PCFG, 960, device="cpu")
    b = rt.ReacqStreamingRx(PCFG, 960, device="cpu")
    j = jrt.ReacqStreamingRx(CFG, 960)
    seq = [a.push(c) for c in chunks]
    for g in range(0, 12, 4):
        many = b.push_many(chunks[g:g + 4])
        jmany = j.push_many(chunks[g:g + 4])
        for f in many._fields:
            got = getattr(many, f)
            assert torch.equal(got, torch.stack(
                [getattr(o, f) for o in seq[g:g + 4]])), f
        _assert_same(many, jmany, f"group {g}")
    for f, v in a.state._asdict().items():
        assert torch.equal(v, getattr(b.state, f)), f
    with pytest.raises(ValueError):
        b.push_many(chunks[:, :900])
    with pytest.raises(ValueError):
        b.push(chunks[0][:900])


def test_batch_receiver_equals_independent_streams_and_jax():
    """B streams stepped together == B single receivers == the JAX batch
    receiver, through push_many ([K, B, chunk]) and push; finish() flushes
    all with one n_real."""
    chunk = 960
    sigs = [_faded(CFG, seed + 10)[1] for seed in range(3)]
    n = min(len(s) for s in sigs) // chunk * chunk
    chunks = np.stack([s[:n] for s in sigs]).reshape(3, -1, chunk).transpose(
        1, 0, 2)                                       # [K, B, chunk]
    brx = rt.BatchReacqStreamingRx(PCFG, chunk, batch=3, device="cpu")
    jbrx = jrt.BatchReacqStreamingRx(CFG, chunk, batch=3)
    many, jmany = brx.push_many(chunks[:8]), jbrx.push_many(chunks[:8])
    assert many.ptrs.shape == (8, 3, brx.det_max)
    _assert_same(many, jmany, "push_many")
    rest = [brx.push(kc) for kc in chunks[8:]] + brx.finish()
    jrest = [jbrx.push(kc) for kc in chunks[8:]] + jbrx.finish()
    for o, jo in zip(rest, jrest):
        _assert_same(o, jo, "push")
    for b in range(3):
        one = rt.ReacqStreamingRx(PCFG, chunk, device="cpu")
        outs = [one.push(c) for c in chunks[:, b]] + one.finish()
        for i, o in enumerate(outs):
            got = many if i < 8 else rest[i - 8]
            sel = (i, b) if i < 8 else (b,)
            for f in o._fields:
                x, y = getattr(o, f), getattr(got, f)[sel]
                if x.dtype.is_floating_point or x.dtype.is_complex:
                    # a stream's FFTs may round otherwise inside a batch,
                    # and so may K4's twin, a convolution bank, by an ulp
                    # of a peak (~55, where an ulp is 3.8e-6)
                    torch.testing.assert_close(
                        x, y, atol=2e-6, rtol=2e-7 if f == "peaks" else 0)
                else:
                    assert torch.equal(x, y), (f, i, b)


def test_strided_config_stream_equals_batch_and_jax():
    """nfft 128, cp 32, stride 31: three frames with a gap, chunk by chunk
    == whole buffer == the JAX receiver; every block detected once."""
    pcfg = port_cfg(S31)
    parts = []
    for seed in range(3):
        bits, rx = _faded(S31, 20 + seed)
        parts += [rx, np.zeros(45 * seed + 11, np.complex64)]
    sig = np.concatenate(parts)
    chunk = 31 * 80
    srx = rt.ReacqStreamingRx(pcfg, chunk, device="cpu")
    jrx = jrt.ReacqStreamingRx(S31, chunk)
    outs, jouts = _drive(srx, sig, chunk), _drive(jrx, sig, chunk)
    for i, (o, jo) in enumerate(zip(outs, jouts)):
        _assert_same(o, jo, f"chunk {i}")
    assert len(_valid(outs, "ptrs")) == 3 * S31.num_patterns
    batch = stream_rx.make_rx_detections(pcfg, len(sig))(
        torch.from_numpy(sig))
    nb = int(batch.count)
    keep = _valid(outs, "ptrs") <= int(batch.ptrs[:nb].max())
    np.testing.assert_array_equal(_valid(outs, "ptrs")[keep],
                                  batch.ptrs[:nb])
    np.testing.assert_array_equal(_valid(outs, "hard_bits")[keep],
                                  batch.hard_bits[:nb])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reacq_checkpoint_crosses_the_packages(tmp_path, faded, writer):
    """A checkpoint written after 7 chunks by either package resumes in the
    other (and in its own) to the uninterrupted run's outputs."""
    _, rx = faded
    chunk = 960
    buf, n_reals = _padded(rx, chunk)
    chunks = buf.reshape(-1, chunk)

    def run(rx_, start):
        return [rx_.push(c, n_real=n) for c, n in
                zip(chunks[start:], n_reals[start:])] + list(rx_.finish())

    full = run(rt.ReacqStreamingRx(PCFG, chunk, device="cpu"), 0)
    jfull = run(jrt.ReacqStreamingRx(CFG, chunk), 0)
    w = (jrt.ReacqStreamingRx(CFG, chunk) if writer == "jax"
         else rt.ReacqStreamingRx(PCFG, chunk, device="cpu"))
    for c, n in zip(chunks[:7], n_reals[:7]):
        w.push(c, n_real=n)
    w.save_state(tmp_path / "st.npz")
    with np.load(tmp_path / "st.npz") as z:
        assert sorted(z.files) == ["any_det", "base", "hist_im", "hist_re",
                                   "last_det_ptr", "real_end"]
    resumed = rt.ReacqStreamingRx(PCFG, chunk, device="cpu")
    resumed.load_state(tmp_path / "st.npz")
    jresumed = jrt.ReacqStreamingRx(CFG, chunk)
    jresumed.load_state(tmp_path / "st.npz")
    for o, ref in zip(run(resumed, 7), full[7:]):
        _assert_same(o, ref, f"port resumes {writer}'s")
    for o, ref in zip(run(jresumed, 7), jfull[7:]):
        _assert_same(o, ref, f"jax resumes {writer}'s")
    assert len(_valid(full[7:], "ptrs")) > 30
    with pytest.raises(ValueError, match="shape"):
        rt.ReacqStreamingRx(port_cfg(S31), 31 * 80, device="cpu").load_state(
            tmp_path / "st.npz")


def _batch_chunks(chunk, batch, seed):
    """[K, B, chunk] chunks of B faded frames, the last chunk's real
    samples (the frames' end inside it) and the streams' bits."""
    parts = [_faded(CFG, seed + b) for b in range(batch)]
    n = len(parts[0][1])
    buf, n_reals = _padded(parts[0][1], chunk)
    assert 0 < n_reals[-1] < chunk
    pad = np.zeros((batch, len(buf)), np.complex64)
    pad[:, :n] = np.stack([p[1] for p in parts])
    return (pad.reshape(batch, -1, chunk).transpose(1, 0, 2), n_reals[-1],
            [p[0] for p in parts])


def _eager_chain(rx, chunks, n_last):
    """The functional ``reacq_step`` on rx's paths, chunk by chunk from an
    empty carry: full chunks, the last with n_last real samples, then the
    flush; returns (outputs, final carry)."""
    state = rt.reacq_init(rx.cfg, rx.device, rx.batch)
    outs = []
    flush = np.zeros_like(chunks[0])
    steps = [(c, rx.chunk_len) for c in chunks[:-1]] + [(chunks[-1], n_last)]
    steps += [(flush, 0)] * (-(-rx.lag // rx.chunk_len))
    for c, n in steps:
        state, out = rx._step(state, torch.from_numpy(c), n)
        outs.append(out)
    return outs, state


@pytest.mark.parametrize("batch", [1, 3])
def test_receiver_carry_is_updated_in_place(batch):
    """A batch receiver fed full chunks, a partial chunk and finish() ==
    the functional ``reacq_step`` chain step for step, exactly, with its
    carry the same tensor objects from the first step to the last."""
    chunk = 1504
    chunks, n_last, bits = _batch_chunks(chunk, batch, 40)
    rx = rt.BatchReacqStreamingRx(PCFG, chunk, batch, device="cpu")
    carry = list(rx.state)
    outs = [rx.push(c) for c in chunks[:-1]]
    outs.append(rx.push(chunks[-1], n_real=n_last))
    outs += rx.finish()
    assert all(a is b for a, b in zip(rx.state, carry))
    ref, ref_state = _eager_chain(rx, chunks, n_last)
    assert len(outs) == len(ref)
    for o, r in zip(outs, ref):
        for f in o._fields:
            assert torch.equal(getattr(o, f), getattr(r, f)), f
    for a, b in zip(rx.state, ref_state):
        assert torch.equal(a, b)
    for b in range(batch):
        hard = np.concatenate([_np(o.hard_bits[b])[_np(o.valid[b])]
                               for o in outs])
        np.testing.assert_array_equal(hard.ravel(), bits[b])


def test_load_state_writes_into_the_carry(tmp_path):
    """load_state (and assigning ``state``) copies into the receiver's own
    carry tensors; the resumed stream == the uninterrupted one."""
    chunk = 960
    chunks, n_last, _ = _batch_chunks(chunk, 2, 50)
    whole = rt.BatchReacqStreamingRx(PCFG, chunk, 2, device="cpu")
    full = [whole.push(c) for c in chunks[:-1]] + whole.finish()
    first = rt.BatchReacqStreamingRx(PCFG, chunk, 2, device="cpu")
    for c in chunks[:5]:
        first.push(c)
    first.save_state(tmp_path / "st.npz")
    resumed = rt.BatchReacqStreamingRx(PCFG, chunk, 2, device="cpu")
    carry = list(resumed.state)
    resumed.load_state(tmp_path / "st.npz")
    assert all(a is b for a, b in zip(resumed.state, carry))
    for a, b in zip(resumed.state, first.state):
        assert torch.equal(a, b)
    rest = [resumed.push(c) for c in chunks[5:-1]] + resumed.finish()
    for o, ref in zip(rest, full[5:], strict=True):
        for f in o._fields:
            assert torch.equal(getattr(o, f), getattr(ref, f)), f
    other = rt.BatchReacqStreamingRx(PCFG, chunk, 2, device="cpu")
    other.state = first.state
    assert all(a is b for a, b in zip(other.state, other._carry))
    assert torch.equal(other.state.hist, first.state.hist)
    assert int(_valid(rest, "ptrs").size) > 10


def test_cpu_receiver_never_captures(monkeypatch):
    """On the CPU every chunk step, full or partial, runs eagerly: no
    capture is tried, and under a profiler ``ofdm.graph_steps`` keeps a 0
    a step beside the step's detection and slot counters."""
    def no_capture(*args):
        raise AssertionError("a CPU receiver captured a CUDA graph")

    monkeypatch.setattr(rt.ReacqStreamingRx, "_capture", no_capture)
    chunk = 960
    chunks, n_last, _ = _batch_chunks(chunk, 2, 60)
    rx = rt.BatchReacqStreamingRx(PCFG, chunk, 2, device="cpu")
    profiling.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            outs = [rx.push(c) for c in chunks[:4]]
            outs.append(rx.push(chunks[4], n_real=chunk // 2))
        assert profiling.kept("ofdm.graph_steps") == [0] * 5
        assert profiling.counters()["ofdm.detections"] == (
            sum(int(o.valid.sum()) for o in outs), 5)
    finally:
        profiling.reset_counters()
    rx.finish()
    assert rx._graph is None


@pytest.mark.parametrize("make", [
    lambda: rt.LegacyStreamingRx(PCFG, 960, device="cpu"),
    lambda: streaming.ShardedReacqStreamingRx(
        PCFG, 1920, pmesh.time_mesh(2, device="cpu"))],
    ids=["legacy", "sharded"])
def test_other_receivers_keep_the_eager_push(make, faded):
    """The legacy and the sharded receivers step eagerly and take each new
    carry as the step returns it: the shared front end's push, not the
    reacq receiver's."""
    rx = make()
    assert type(rx).push is rt.EagerStreamingRx.push
    assert not isinstance(rx, rt.ReacqStreamingRx)
    before = rx.state
    rx.push(_chunks_of(faded[1], rx.chunk_len)[0])
    assert all(a is not b for a, b in zip(rx.state, before))


# ---------------------------------------------------------------------------
# the single-lock stream
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def noisy():
    bits, tx = _tx(CFG, 0)
    rx = golden.apply_channel(tx, golden.channel_taps("Fading"),
                              max_impulse=64)
    return golden.awgn(CFG, rx, np.random.default_rng(1),
                       np.var(tx)).astype(np.complex64)


def _drive_single(rx, sig, chunk):
    buf, _ = _padded(sig, chunk)
    return [rx.push(c) for c in buf.reshape(-1, chunk)] + [rx.finish()]


@pytest.mark.parametrize("chunk", [320, 640, 960, 1600])
def test_streaming_rx_equals_jax(noisy, chunk):
    """Lock flag, lock pointer and block ids exactly, phasors within 2e-4,
    chunk by chunk, for chunks shorter and longer than a pattern block;
    every pattern block comes out once."""
    srx = rt.StreamingRx(PCFG, chunk, device="cpu")
    outs = _drive_single(srx, noisy, chunk)
    jouts = _drive_single(jrt.StreamingRx(CFG, chunk), noisy, chunk)
    for i, (o, jo) in enumerate(zip(outs, jouts)):
        _assert_same(o, jo, f"chunk {i}")
    ids = np.concatenate([_np(o.block_ids) for o in outs])
    assert sorted(ids[ids >= 0]) == list(range(CFG.num_patterns))
    assert bool(outs[-1].found) and outs[-1].block_ids.dtype == torch.int32


def test_streaming_rx_push_many_checkpoint_and_noise(tmp_path, noisy):
    """push_many == pushes; the ten-key checkpoint crosses the packages both
    ways; no lock on noise."""
    chunk = 640
    chunks = _chunks_of(noisy, chunk)
    a = rt.StreamingRx(PCFG, chunk, device="cpu")
    b = rt.StreamingRx(PCFG, chunk, device="cpu")
    j = jrt.StreamingRx(CFG, chunk)
    seq = [a.push(c) for c in chunks[:8]]
    many = [b.push_many(chunks[g:g + 4]) for g in (0, 4)]
    jmany = [j.push_many(chunks[g:g + 4]) for g in (0, 4)]
    for g in range(2):
        for f in many[g]._fields:
            assert torch.equal(getattr(many[g], f), torch.stack(
                [getattr(o, f) for o in seq[4 * g:4 * g + 4]])), f
        _assert_same(many[g], jmany[g], "push_many")
    assert bool(a.state.locked)

    a.save_state(tmp_path / "port.npz")
    j.save_state(tmp_path / "jax.npz")
    with np.load(tmp_path / "port.npz") as z, \
            np.load(tmp_path / "jax.npz") as jz:
        assert sorted(z.files) == sorted(jz.files) and len(z.files) == 10
    ref = [a.push(c) for c in chunks[8:12]]
    jref = [j.push(c) for c in chunks[8:12]]
    for path in ("port.npz", "jax.npz"):
        r = rt.StreamingRx(PCFG, chunk, device="cpu")
        r.load_state(tmp_path / path)
        jr = jrt.StreamingRx(CFG, chunk)
        jr.load_state(tmp_path / path)
        for c, o, jo in zip(chunks[8:12], ref, jref):
            _assert_same(r.push(c), o, f"port resumes {path}")
            _assert_same(jr.push(c), jo, f"jax resumes {path}")

    rng = np.random.default_rng(9)
    quiet = rt.StreamingRx(PCFG, chunk, device="cpu")
    for _ in range(6):
        out = quiet.push(0.05 * (rng.standard_normal(chunk) +
                                 1j * rng.standard_normal(chunk)))
    assert not bool(out.found) and not bool(out.valid.any())


# ---------------------------------------------------------------------------
# the device rule and the wrappers' CUDA branches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda **kw: rt.ReacqStreamingRx(PCFG, 960, **kw),
    lambda **kw: rt.BatchReacqStreamingRx(PCFG, 960, batch=2, **kw),
    lambda **kw: rt.StreamingRx(PCFG, 640, **kw)],
    ids=["reacq", "batch", "single-lock"])
def test_receiver_without_device_raises_where_there_is_no_cuda(monkeypatch,
                                                               make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}, {"device": "cuda:0"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(**kw)
    assert make(device="cpu").device == torch.device("cpu")


def test_kernel_defaults_follow_the_device(faded):
    """The device alone picks kernel or twin: on a CPU buffer the
    receivers' per-trial peaks and delays, and the lock of ``rx_frame``,
    are bit for bit those of K4's plain twin and ``lock_from_peaks``, and
    their demod is K2's twin; no launch is made."""
    from lte_gnu_radio_code_tpu_torch.kernels import equalize, sync_search
    from lte_gnu_radio_code_tpu_torch.models import rxofdm

    _, rx = faded
    x = torch.from_numpy(rx)
    n_trials, num_patterns = rxofdm.plan_rx(PCFG, len(rx))
    kernels.reset_launch_counts()
    peak, delay = sync_search.sync_peaks_plain(PCFG, x, n_trials)
    got = stream_rx.detect_trials(PCFG, x, n_trials)
    assert torch.equal(got[0], peak) and torch.equal(got[1], delay)
    lock = sync.lock_from_peaks(PCFG, peak, delay)
    r = rxofdm.rx_frame(PCFG, x, n_trials, num_patterns)
    for a, b in zip((r.lock_ptr, r.delay_idx, r.peak, r.found), lock):
        assert torch.equal(a, b)
    coeff = equalize.combined_coeff(
        PCFG, r.delay_idx, sync.estimate_channel(
            PCFG, sync.sync_spectrum_at(PCFG, x, lock[4]), r.delay_idx)[1])
    win = equalize.data_windows(PCFG, x, r.lock_ptr, num_patterns)
    assert torch.equal(r.phasors, equalize.demod_windows_plain(
        PCFG, win, coeff.contiguous()))
    assert sum(kernels.launch_counts().values()) == 0
    with pytest.raises(ValueError, match="stride"):
        rt.ReacqStreamingRx(port_cfg(S31), 1000, device="cpu")


def _record_launches(monkeypatch):
    """The wrappers' CUDA branches with the launch recorded, not made."""
    calls = []

    class Library:
        @staticmethod
        def sync_search_direct_fits(*args):
            return 1

    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "library", Library)
    monkeypatch.setattr(_cuda, "launch", recorded_launch(calls))
    return calls


@pytest.mark.parametrize("cfg,entry", [(CFG, "sync_search_direct"),
                                       (S31, "sync_search_direct"),
                                       (reduced(CFG, nfft=1024, cp_len=256,
                                                num_synch_bins=1022,
                                                num_data_bins=960,
                                                num_ofdm_symb=8, stride=255),
                                        "sync_search_fft")],
                         ids=["golden64", "stride31", "lte1024"])
def test_batch_step_hands_the_kernels_contiguous_tensors(monkeypatch, cfg,
                                                         entry):
    """One chunk step of B streams on the kernel path: K4 is launched once
    on one contiguous [B, lag + chunk] tensor, K2 once on contiguous
    [B*det_max*nd, nfft] rows with contiguous [rows, B] coefficients
    (their wrappers refuse any other), whatever B is; the carried history
    is a copy, not a view that keeps the step's ext alive."""
    pcfg = port_cfg(cfg)
    chunk = 4 * max(1, cfg.stride) * 10
    calls = _record_launches(monkeypatch)
    kernels.reset_launch_counts()
    for batch in (1, 3):
        rx = rt.BatchReacqStreamingRx(pcfg, chunk, batch, device="cpu")
        x = torch.from_numpy(np.random.default_rng(batch).standard_normal(
            (2, batch, chunk)).astype(np.complex64))
        calls.clear()
        rx.push_many(x)
        assert [name for name, _ in calls] == [entry, "equalize_fft"] * 2
        for name, args in calls:
            assert len(args) + 1 == len(_cuda.SIGNATURES[name])
        search, demod = calls[0][1], calls[1][1]
        assert search[1:3] == (batch, rt.reacq_lag(pcfg) + chunk)
        assert search[6] == chunk // max(1, cfg.stride)     # trials
        rows = batch * rx.det_max * cfg.synch_dat[1]
        assert demod[4] == cfg.num_data_bins           # one coeff row a window
        assert demod[6:9] == (rows, cfg.nfft, cfg.num_data_bins)
        assert rx.state.hist.is_contiguous() and rx.state.hist._base is None
    assert kernels.launch_counts()["sync_search"] == 4
    assert kernels.launch_counts()["equalize"] == 4
    kernels.reset_launch_counts()


def test_demod_detections_kernel_path_rows(monkeypatch, faded):
    """demod_detections flattens streams x slots x nd into K2's rows;
    empty slots stay in (pointer 0, zero coefficient); each stream's rows
    equal the JAX package's DFT demod."""
    from lte_gnu_radio_code_tpu_torch.kernels import equalize
    _, rx = faded
    seen = []
    real = equalize.demod_windows

    def spy(cfg, win, coeff):
        seen.append((win, coeff))
        return real(cfg, win, coeff)

    monkeypatch.setattr(equalize, "demod_windows", spy)
    ext = torch.from_numpy(np.stack([rx[:4000], rx[100:4100]]))
    ptrs = torch.tensor([[16, 336, 0, 0, 0], [236, 0, 0, 0, 0]])
    valid = ptrs > 0
    chans, ph, ok = stream_rx.demod_detections(
        PCFG, ext, ptrs, torch.ones_like(ptrs), valid, 4000)
    (win, coeff), = seen
    assert win.shape == (2 * 5 * 3, 64) and win.is_contiguous()
    assert coeff.shape == (30, 60) and coeff.is_contiguous()
    assert not bool(coeff.reshape(2, 5, 3, 60)[~valid].any())
    assert bool(coeff.reshape(2, 5, 3, 60)[valid].all())
    assert torch.equal(ok, valid) and not bool(ph[~valid].any())
    for s in range(2):
        jchans, jph, jok = jstream_rx.demod_detections(
            CFG, jnp.asarray(ext[s].numpy()), jnp.asarray(ptrs[s].numpy()),
            jnp.ones(5, jnp.int32), jnp.asarray(valid[s].numpy()), 4000,
            demod_path="dft")
        np.testing.assert_allclose(ph[s], np.asarray(jph), atol=ATOL, rtol=0)
        np.testing.assert_allclose(chans[s], np.asarray(jchans), atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(ok[s], np.asarray(jok))
    late = stream_rx.demod_detections(
        PCFG, ext, ptrs, torch.ones_like(ptrs), valid,
        torch.tensor([4000, 500]))
    assert late[2].tolist() == [[True, True, False, False, False],
                                [False] * 5]
    assert not bool(late[1][1].any())


@pytest.mark.parametrize("init", ["init_state", "reacq_init", "legacy_init",
                                  "track_stream_init", "tracker_init_carry"])
def test_empty_carries_default_to_the_card(init):
    """The receivers' empty carries, as every entry point, lie on the CUDA
    device unless the caller asks for the CPU, and raise where there is no
    card (``utils/device.py:resolve_device``); with device "cpu" they lie
    on the CPU."""
    from lte_gnu_radio_code_tpu_torch.models import tracker

    cfg = port_cfg(GOLDEN64)
    make = {"init_state": lambda **k: rt.init_state(cfg, 960, **k),
            "reacq_init": lambda **k: rt.reacq_init(cfg, **k),
            "legacy_init": lambda **k: rt.legacy_init(cfg, **k),
            "track_stream_init": lambda **k: rt.track_stream_init(cfg, **k),
            "tracker_init_carry": lambda **k: tracker.tracker_init_carry(
                2, **k)}[init]

    def fields(state):
        if isinstance(state, torch.Tensor):
            return [state]
        return [t for v in state for t in fields(v)]

    assert {t.device.type for t in fields(make(device="cpu"))} == {"cpu"}
    if torch.cuda.is_available():
        assert {t.device.type for t in fields(make())} == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
