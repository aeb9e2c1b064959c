"""The tracker of the PyTorch port on the CPU (``models/tracker.py``, the
plain twin of ``kernels/tracker.py:track_scan`` and
``runtime/stream.py:TrackerStreamingRx``), against the JAX package and its
numpy oracle on seeded buffers.

Exact: every integer carry field, the history (int32 here, float32 global
indices in the JAX package: equal after the cast while they lie below
2^24), accepts, pointers, delays, counts and hard bits.  The fit ``b`` is
held to the float64 fit of the same history: the port fits on differences
from the newest entry, exactly (``models/tracker.py``), where the JAX
package's float32 fit on global indices rounds, so that at a fitted value
that is an integer (every fit of a drift-free stream) its ceiling may land
one above; the two packages' pointers are then held by the symbol boundary
ptr + delay, and the port's to the plain float64 reference of the
benchmark (``ofdm_bench/reference/tracker.py``).  Within tolerance: peaks
1e-5 of their size (they reach m_synch * num_synch_bins; the two FFTs
round differently), channel estimates 1e-5, phasors 2e-4 (the JAX
package's, tests/test_stream_rx.py).  The kernel is held to its plain twin
on a CUDA device by tests/test_torch_cuda.py."""

import dataclasses
import inspect
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from lte_gnu_radio_code_tpu.models import tracker as jtrk
from lte_gnu_radio_code_tpu.reference_cpu import golden as G
from lte_gnu_radio_code_tpu.reference_cpu import tracker as oracle
from lte_gnu_radio_code_tpu.runtime import stream as jrt
from lte_gnu_radio_code_tpu.utils import params as jparams
from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
from lte_gnu_radio_code_tpu_torch.models import tracker as trk
from lte_gnu_radio_code_tpu_torch.reference_cpu import tracker as poracle
from lte_gnu_radio_code_tpu_torch.runtime import stream as rt
from ofdm_bench.reference import tracker as plain_ref
from ofdm_bench.reference.numerology import RefConfig
from torch_parity import port_cfg

CHAN_ATOL = 1e-5
PH_ATOL = 2e-4
PEAK_RTOL = 1e-5
GAP = 3                  # zero samples inserted mid-stream in the drift case

G64 = jparams.GOLDEN64
M2 = dataclasses.replace(G64, synch_dat=(2, 2), num_ofdm_symb=48).validate()
_LTE_SHORT = dataclasses.replace(jparams.LTE1024, num_ofdm_symb=16)


def _buffer(cfg, seed=0, snr_db=80.0, gap_at=None):
    """tests/test_tracker.py's buffer: one seeded frame through the numpy
    TX and the Fading channel plus noise at snr_db; with ``gap_at``, GAP
    zero samples inserted there."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, cfg.num_bits)
    tx = G.tx_frame(cfg, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    nv = np.var(tx) * 10 ** (-snr_db / 10)
    rx = rx + np.sqrt(nv / 2) * (rng.standard_normal(len(rx)) +
                                 1j * rng.standard_normal(len(rx)))
    if gap_at is not None:
        rx = np.concatenate([rx[:gap_at], np.zeros(GAP), rx[gap_at:]])
    return bits, rx.astype(np.complex64)


@pytest.fixture(scope="module")
def golden():
    return _buffer(G64)


def _jax_scan(cfg, rx):
    """The JAX step's carry after every step, and its outputs."""
    n = len(rx)
    step = jtrk.make_tracker_step(cfg, jnp.asarray(rx), 0, n)
    steps = int(np.ceil(n / jtrk.tracker_stride(cfg))) + 1

    def body(c, _):
        c1, ys = step(c, None)
        return c1, (c1, ys)

    _, (carries, ys) = jax.jit(lambda: lax.scan(
        body, jtrk.tracker_init_carry(), None, length=steps))()
    return steps, [np.asarray(c) for c in carries], [np.asarray(y)
                                                      for y in ys]


def _fit64(hx, hy, n_eff, newest, pattern):
    """The float64 fit of ``_masked_lstsq`` (b0 at the next entry's x less
    the newest entry's y, b1 the slope), from int64 histories [..., 5]."""
    w = np.arange(5) < np.asarray(n_eff)[..., None]
    at = np.asarray(newest)[..., None]
    u = np.where(w, (hx - np.take_along_axis(hx, at, -1)) // pattern, 0.0)
    v = np.where(w, hy - np.take_along_axis(hy, at, -1), 0.0)
    s0, s1, s2 = w.sum(-1), u.sum(-1), (u * u).sum(-1)
    sy, sxy = v.sum(-1), (u * v).sum(-1)
    det = s0 * s2 - s1 * s1
    num1 = s0 * sxy - s1 * sy
    safe = det > 0
    det = np.where(safe, det, 1.0)
    return np.stack([np.where(safe, (s2 * sy - s1 * sxy + num1) / det, 0.0),
                     np.where(safe, num1 / (det * pattern), 0.0)], -1)


def test_plain_step_carry_bits_equal_jax(golden):
    """Step by step over the GOLDEN64 buffer: the plain step's integer
    carry fields, accepts, pointers and delays equal the JAX scan's; its
    int32 history equals the JAX float32 one after the cast, bit for bit;
    its fit b equals the float64 fit of its own history within one float32
    rounding (b0 at the next entry relative to the newest, where the JAX
    package keeps b0 at x = 0)."""
    _, rx = golden
    steps, jcarries, jys = _jax_scan(G64, rx)
    cfg = port_cfg(G64)
    x = torch.from_numpy(rx)[None]
    step = trk.make_tracker_step(cfg, x, 0, x.shape[1])
    carry = trk.tracker_init_carry(1, device="cpu")
    carries, ys = [], []
    for _ in range(steps):
        carry, y = step(carry)
        carries.append(carry)
        ys.append(y)
    ours = {name: torch.stack([c[i][0] for c in carries]).numpy()
            for i, name in enumerate(trk.TrackerCarry._fields)}
    for i, name in enumerate(trk.TrackerCarry._fields[:6]):
        np.testing.assert_array_equal(ours[name], jcarries[i], err_msg=name)
    for i, name in ((6, "hx"), (7, "hy")):
        assert ours[name].dtype == np.int32 and ours[name].max() < 2 ** 24
        np.testing.assert_array_equal(
            ours[name].astype(np.float32).view(np.int32),
            jcarries[i].view(np.int32), err_msg=name)
    co, sc = ours["corr_obs"], ours["sym_count"]
    fit = np.where((co >= 4)[:, None], _fit64(
        ours["hx"].astype(np.int64), ours["hy"].astype(np.int64),
        np.minimum(co, 5), (sc + 4) % 5, G64.pattern_len), 0.0)
    np.testing.assert_allclose(ours["b"], fit, rtol=2.0 ** -23, atol=0)
    acc, ptr, delay, peak, h = (torch.stack([y[k][0] for y in ys]).numpy()
                                for k in range(5))
    for name, mine, ref in (("accept", acc, jys[0]), ("ptr", ptr, jys[1]),
                            ("delay", delay, jys[2])):
        np.testing.assert_array_equal(mine, ref, err_msg=name)
    np.testing.assert_allclose(peak, jys[3], rtol=PEAK_RTOL)
    np.testing.assert_allclose(h, jys[4], atol=CHAN_ATOL)
    # the least-squares predictor took over: pointers came from b
    assert int(acc.sum()) == G64.num_patterns and (jcarries[1] >= 5).any()


@pytest.mark.parametrize("x_max,y_max", [(300, 40000), (2 ** 21, 2 ** 30)],
                         ids=["frame", "stream"])
def test_masked_lstsq_bits_equal_jax(x_max, y_max):
    """The fit on histories as the tracker writes them (five consecutive
    sym_counts, each entry a pattern of 320 samples after the one before,
    give or take a few), at the sizes a frame gives and at global indices
    up to 2^30 (a stream): b within one float32 rounding of the float64
    fit, and the prediction's ceiling equal to the exact one (Fraction)
    on every row, the integer-valued fits of drift-free rows included.  The
    JAX package's float32 fit on global indices misses it by a sample or
    two on some of the frame's rows (one above on an integer-valued one),
    and on the stream's misses every row, by more than 2 cp on some."""
    rng = np.random.default_rng(5)
    rows, pattern, cp = 64, 4, 16
    sc = rng.integers(5, x_max, rows)                     # the next entry
    step = np.arange(-5, 0)
    hx = ((sc[:, None] + step) * pattern)
    base = rng.integers(0, y_max, rows)
    jitter = rng.integers(-2, 3, (rows, 5)) * (rng.random((rows, 1)) < 0.5)
    hy = base[:, None] + (step + 5) * 320 + jitter
    # entry i sits in slot (its sym_count) mod 5
    slot = (sc[:, None] + step) % 5
    hx = np.take_along_axis(hx, np.argsort(slot, 1), 1)
    hy = np.take_along_axis(hy, np.argsort(slot, 1), 1)
    newest = (sc - 1) % 5
    n_eff = np.full(rows, 5)
    ours = trk._masked_lstsq(torch.from_numpy(hx.astype(np.int32)),
                             torch.from_numpy(hy.astype(np.int32)),
                             torch.from_numpy(n_eff), torch.from_numpy(newest),
                             pattern).numpy()
    np.testing.assert_allclose(ours, _fit64(hx, hy, n_eff, newest, pattern),
                               rtol=2.0 ** -23, atol=0)
    pred = trk._predict(torch.from_numpy(hy.astype(np.int32)),
                        torch.from_numpy(ours), torch.from_numpy(
                            sc.astype(np.int32)), cp).numpy()
    jax_off = []
    for r in range(rows):
        x = [Fraction(int(v)) for v in hx[r]]
        y = [Fraction(int(v)) for v in hy[r]]
        s1, s2 = sum(x), sum(v * v for v in x)
        sy, sxy = sum(y), sum(a * c for a, c in zip(x, y))
        b1 = (5 * sxy - s1 * sy) / (5 * s2 - s1 * s1)
        exact = (sy - b1 * s1) / 5 + b1 * int(sc[r]) * pattern - Fraction(
            cp, 4)
        assert pred[r] == -(-exact.numerator // exact.denominator), r
        jb = np.asarray(jax.jit(jtrk._masked_lstsq)(
            jnp.asarray(hx[r], jnp.float32), jnp.asarray(hy[r], jnp.float32),
            jnp.int32(5)))
        jp = np.ceil(np.float32(jb[0] + jb[1] * np.float32(sc[r] * pattern))
                     - np.float32(cp / 4))
        if int(jp) != pred[r]:
            jax_off.append((int(jp) - pred[r], exact.denominator))
    if x_max == 300:    # JAX rounds: off by a sample or two on some rows
        assert jax_off and max(abs(d) for d, _ in jax_off) <= 2
        assert (1, 1) in jax_off      # an integer-valued fit, one above
    else:               # JAX loses the stream's cadence
        assert len(jax_off) == rows
        assert max(abs(d) for d, _ in jax_off) > 2 * cp


def _assert_frame_equal(ours, ref):
    n = int(ref.count)
    assert int(ours.count) == n
    for name in ("ptrs", "delays", "hard_bits"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(ours.peaks.numpy(), np.asarray(ref.peaks),
                               rtol=PEAK_RTOL)
    np.testing.assert_allclose(ours.chan_freq.numpy(),
                               np.asarray(ref.chan_freq), atol=CHAN_ATOL)
    np.testing.assert_allclose(ours.phasors.numpy(), np.asarray(ref.phasors),
                               atol=PH_ATOL)
    return n


def _assert_boundaries_equal(ours, ref):
    """The detections as symbol boundaries: count, ptr + delay and the hard
    bits equal."""
    n = int(ref.count)
    assert int(ours.count) == n
    np.testing.assert_array_equal((ours.ptrs + ours.delays).numpy(),
                                  np.asarray(ref.ptrs + ref.delays))
    np.testing.assert_array_equal(ours.hard_bits.numpy(),
                                  np.asarray(ref.hard_bits))
    return n


def _ref_cfg(cfg):
    return RefConfig.from_keywords(dataclasses.asdict(cfg))


def _assert_plain_reference(cfg, rx, ours):
    """The port's detections == the plain float64 reference's
    (``ofdm_bench/reference/tracker.py``, the same samples from an empty
    state): count, pointers and delays exactly, channels within
    CHAN_ATOL."""
    _, dets, _, _, _ = plain_ref.track(_ref_cfg(cfg),
                                       np.asarray(rx, np.complex128))
    n = int(ours.count)
    assert n == len(dets)
    np.testing.assert_array_equal(ours.ptrs[:n].numpy(),
                                  [d.ptr for d in dets])
    np.testing.assert_array_equal(ours.delays[:n].numpy(),
                                  [d.delay for d in dets])
    np.testing.assert_allclose(ours.chan_freq[:n].numpy(),
                               torch.stack([d.chan for d in dets]).numpy(),
                               atol=CHAN_ATOL)


@pytest.mark.parametrize("case", ["golden64", "m_synch2", "drift",
                                  "lte1024"])
def test_track_frame_equals_jax(case):
    """Whole buffer: the port's track_frame == the JAX one, on GOLDEN64, an
    m_synch = 2 frame, a GOLDEN64 stream with GAP samples inserted mid
    stream (the tracker re-adjusts; the symbols before the gap decode) and
    a short LTE1024 frame (the block route's widths: nfft 1024, cp 256).
    With m_synch = 2 both packages demodulate the symbol (j + 1) * (nfft +
    cp) after a detection's pointer, the second synch symbol first, as the
    reference's rx_data_demod does: their bits are equal, and about half of
    them differ from the sent ones."""
    cfg = {"m_synch2": M2, "lte1024": _LTE_SHORT}.get(case, G64)
    gap_at = 9600 + 37 if case == "drift" else None
    bits, rx = _buffer(cfg, gap_at=gap_at)
    ref = jtrk.make_tracker(cfg, len(rx))(jnp.asarray(rx))
    ours = trk.make_tracker(port_cfg(cfg), len(rx), device="cpu")(rx)
    if case == "drift":
        # the drifted fits land on integers, where the JAX package's float32
        # fit rounds a pointer one above (and its delay one below)
        n = _assert_boundaries_equal(ours, ref)
        _assert_plain_reference(cfg, rx, ours)
    else:
        n = _assert_frame_equal(ours, ref)
    assert n == cfg.num_patterns
    if case == "m_synch2":
        return
    hard = ours.hard_bits.numpy()
    upto = cfg.num_bits if gap_at is None else (
        (gap_at // (cfg.pattern_len * cfg.rx_b_len) - 1) *
        cfg.synch_dat[1] * cfg.num_data_bins * 2)
    np.testing.assert_array_equal(hard[:upto], bits[:upto])


def test_track_frame_batch_equals_single(golden):
    """A stream axis: two buffers at once == each alone (the floats within
    the tolerances: a batch of two rounds its products differently)."""
    _, rx = golden
    _, rx2 = _buffer(G64, seed=1)
    cfg = port_cfg(G64)
    f = trk.make_tracker(cfg, len(rx), device="cpu")
    both = f(np.stack([rx, rx2]))
    for b, one in enumerate((f(rx), f(rx2))):
        _assert_frame_equal(trk.TrackResult(*(v[b] for v in both)), one)


def test_track_frame_matches_numpy_oracle(golden):
    """The numpy oracle (reference_cpu/tracker.py): the same detections
    (the resolved symbol boundary ptr + delay) and the same hard bits."""
    bits, rx = golden
    tr = oracle.track_synch(G64, rx.astype(np.complex128))
    n = tr["n_det"]
    ours = trk.make_tracker(port_cfg(G64), len(rx), device="cpu")(rx)
    assert int(ours.count) == n == G64.num_patterns
    tsr = tr["time_synch_ref"]
    np.testing.assert_array_equal(
        (ours.ptrs + ours.delays)[:n].numpy(), (tsr[:n, 0] +
                                                tsr[:n, 1]).astype(int))
    hard_o, _, _ = G.bit_recovery(oracle.data_demod(G64, rx, tr,
                                                    fix_rotation=True))
    nb = min(len(hard_o), ours.hard_bits.shape[0])
    np.testing.assert_array_equal(ours.hard_bits[:nb].numpy(), hard_o[:nb])
    np.testing.assert_array_equal(ours.hard_bits[:len(bits)].numpy(), bits)


def _stream(rx_obj, sig, chunk):
    """sig pushed in chunks (the last one zero-padded, with its real
    sample count), then finish(): the valid detections' fields."""
    buf = np.zeros(-(-len(sig) // chunk) * chunk, np.complex64)
    buf[:len(sig)] = sig
    outs = [rx_obj.push(buf[i:i + chunk], n_real=max(0, min(chunk,
                                                            len(sig) - i)))
            for i in range(0, len(buf), chunk)]
    outs += rx_obj.finish()
    return {name: np.concatenate([np.asarray(getattr(o, name))[
        np.asarray(o.valid)] for o in outs])
        for name in ("ptrs", "delays", "peaks", "chans", "phasors",
                     "hard_bits")}


@pytest.mark.parametrize("chunk", [960, 2400])
def test_stream_equals_batch(golden, chunk):
    """Chunked == the whole buffer, in the port (exactly, every field) and
    against the JAX TrackerStreamingRx (at chunk 960)."""
    bits, rx = golden
    cfg = port_cfg(G64)
    whole = trk.make_tracker(cfg, len(rx), device="cpu")(rx)
    got = _stream(rt.TrackerStreamingRx(cfg, chunk, device="cpu"), rx, chunk)
    n = int(whole.count)
    assert len(got["ptrs"]) == n == G64.num_patterns
    np.testing.assert_array_equal(got["ptrs"], whole.ptrs[:n].numpy())
    np.testing.assert_array_equal(got["delays"], whole.delays[:n].numpy())
    np.testing.assert_array_equal(got["hard_bits"].reshape(-1),
                                  whole.hard_bits.numpy())
    np.testing.assert_allclose(got["chans"], whole.chan_freq[:n].numpy(),
                               atol=CHAN_ATOL)
    np.testing.assert_allclose(got["phasors"].reshape(n, -1),
                               whole.phasors.reshape(n, -1).numpy(),
                               atol=PH_ATOL)
    if chunk == 960:
        ref = _stream(jrt.TrackerStreamingRx(G64, chunk), rx, chunk)
        for name in ("ptrs", "delays", "hard_bits"):
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
        np.testing.assert_allclose(got["peaks"], ref["peaks"],
                                   rtol=PEAK_RTOL)
        np.testing.assert_allclose(got["chans"], ref["chans"],
                                   atol=CHAN_ATOL)
        np.testing.assert_allclose(got["phasors"], ref["phasors"],
                                   atol=PH_ATOL)


def test_push_many_equals_pushes(golden):
    _, rx = golden
    cfg, chunk = port_cfg(G64), 960
    chunks = rx[:9 * chunk].reshape(9, chunk)
    a = rt.TrackerStreamingRx(cfg, chunk, device="cpu")
    b = rt.TrackerStreamingRx(cfg, chunk, device="cpu")
    outs_a = [a.push(c) for c in chunks]
    many = [b.push_many(chunks[i:i + 3]) for i in range(0, 9, 3)]
    for name in rt.TrackChunkOut._fields:
        x = torch.stack([getattr(o, name) for o in outs_a])
        y = torch.cat([getattr(o, name) for o in many])
        assert torch.equal(x, y), name
    for x, y in zip(a.state.carry, b.state.carry):
        assert torch.equal(x, y)
    assert int(a.state.base) == int(b.state.base) == 9 * chunk


def test_batch_stream_equals_single_streams():
    """BatchTrackerStreamingRx on two GOLDEN64 streams == a
    TrackerStreamingRx on each, chunk by chunk, finish included: every
    integer field exactly, the floats within the tolerances (the plain
    twin's products round by batch on the CPU; on the card each stream is
    one warp or block, and equal bit for bit)."""
    cfg, chunk = port_cfg(G64), 2400
    sigs = np.stack([_buffer(G64, seed=s)[1][:G64.frame_len]
                     for s in (0, 7)])
    batch = rt.BatchTrackerStreamingRx(cfg, chunk, 2, device="cpu")
    assert batch.chunk_shape == (2, chunk)
    got = [batch.push(sigs[:, i:i + chunk])
           for i in range(0, sigs.shape[1], chunk)] + batch.finish()
    for b in range(2):
        one = rt.TrackerStreamingRx(cfg, chunk, device="cpu")
        want = [one.push(sigs[b, i:i + chunk])
                for i in range(0, sigs.shape[1], chunk)] + one.finish()
        assert len(want) == len(got)
        for g, w in zip(got, want):
            for name in rt.TrackChunkOut._fields:
                x, y = getattr(g, name)[b], getattr(w, name)
                if name in ("ptrs", "delays", "valid", "hard_bits"):
                    assert torch.equal(x, y), name
                else:
                    atol = {"chans": CHAN_ATOL, "phasors": PH_ATOL}.get(
                        name, 0)
                    torch.testing.assert_close(x, y, atol=atol,
                                               rtol=PEAK_RTOL)
        for x, y in zip(batch.state.carry[:8], one.state.carry[:8]):
            assert torch.equal(x[b], y[0])
        assert int(batch.state.base[b]) == int(one.state.base)
    assert sum(int(o.valid[0].sum()) for o in got) == G64.num_patterns


BASE = 2 ** 28
LTE10 = dataclasses.replace(jparams.LTE1024, num_data_bins=600,
                            channel_band=9e6, num_ofdm_symb=64)


def _stream_from(rx_obj, start: int):
    """The receiver's empty state moved to global sample ``start`` (a
    multiple of the search stride): its history ends there, its search
    starts there."""
    st = rx_obj.state
    rx_obj.state = st._replace(
        base=torch.full_like(st.base, start),
        real_end=torch.full_like(st.real_end, start),
        carry=st.carry._replace(loop_count=torch.full_like(
            st.carry.loop_count, start // trk.tracker_stride(rx_obj.cfg))))
    return rx_obj


@pytest.mark.parametrize("case", ["golden64", "lte1024"])
def test_stream_at_a_2_28_base(case):
    """A stream whose state starts at global sample 2^28 (past 2^24, where
    float32 holds every integer) gives the detections of the same samples
    at base 0, every pointer 2^28 later and every other field equal bit for
    bit, and the plain float64 reference's pointers and delays.  A GOLDEN64
    frame at 80 dB, and two frames of the l1k-track cell's 10 MHz LTE at
    its 20 dB, where the delays move and the fits are not integers.  The
    parent's float32 fit on global indices loses the pattern grid here."""
    if case == "golden64":
        cfg, chunk, frames, snr = G64, 2400, 1, 80.0
    else:
        cfg, chunk, frames, snr = LTE10, 32768, 2, 20.0
    sig = np.concatenate([_buffer(cfg, seed=s, snr_db=snr)[1][:cfg.frame_len]
                          for s in range(frames)])
    pcfg = port_cfg(cfg)
    assert BASE % trk.tracker_stride(pcfg) == 0
    at0 = _stream(rt.TrackerStreamingRx(pcfg, chunk, device="cpu"), sig,
                  chunk)
    far = _stream(_stream_from(rt.TrackerStreamingRx(pcfg, chunk,
                                                     device="cpu"), BASE),
                  sig, chunk)
    n = len(at0["ptrs"])
    assert n == frames * cfg.num_patterns
    np.testing.assert_array_equal(far["ptrs"], at0["ptrs"] + BASE)
    for name in ("delays", "peaks", "chans", "phasors", "hard_bits"):
        np.testing.assert_array_equal(far[name], at0[name], err_msg=name)
    _, dets, _, _, _ = plain_ref.track(_ref_cfg(cfg),
                                       sig.astype(np.complex128))
    np.testing.assert_array_equal(at0["ptrs"], [d.ptr for d in dets])
    np.testing.assert_array_equal(at0["delays"], [d.delay for d in dets])
    # the sent bits, where the data lies inside the buffer
    bits = np.concatenate([_buffer(cfg, seed=s, snr_db=snr)[0]
                           for s in range(frames)])
    hard = at0["hard_bits"].reshape(-1)
    np.testing.assert_array_equal(hard[:len(bits)], bits)


def _exact_lstsq(X, y, rcond=None):
    """np.linalg.lstsq of the oracle's fit in exact rationals."""
    x = [Fraction(int(v)) for v in X[:, 1]]
    yy = [Fraction(int(v)) for v in y]
    n = len(x)
    s1, s2 = sum(x), sum(v * v for v in x)
    sy, sxy = sum(yy), sum(a * c for a, c in zip(x, yy))
    b1 = (n * sxy - s1 * sy) / (n * s2 - s1 * s1)
    return np.array([float((sy - b1 * s1) / n), float(b1)]), None, None, None


@pytest.mark.parametrize("case", ["golden64", "lte1024"])
def test_plain_reference_equals_the_oracle(case, monkeypatch):
    """The benchmark's plain tracker reference (``ofdm_bench/reference/
    tracker.py``, torch float64) == the port's NumPy oracle
    (``reference_cpu/tracker.py``) on a GOLDEN64 frame and a 32-symbol
    LTE1024 buffer (80 dB): with the oracle's fit made exact (its lstsq in
    rationals) the pointers, delays and count exactly and the channels
    within 1e-12; with the oracle's own float64 lstsq, whose ceiling lands
    one above at some integer-valued fits, the symbol boundaries ptr +
    delay exactly."""
    cfg = G64 if case == "golden64" else dataclasses.replace(
        jparams.LTE1024, num_ofdm_symb=32)
    _, rx = _buffer(cfg)
    x = rx.astype(np.complex128)
    pcfg = port_cfg(cfg)
    _, dets, _, _, _ = plain_ref.track(_ref_cfg(cfg), x)
    ptrs = np.array([d.ptr for d in dets])
    delays = np.array([d.delay for d in dets])
    as_is = poracle.track_synch(pcfg, x)
    monkeypatch.setattr(np.linalg, "lstsq", _exact_lstsq)
    exact = poracle.track_synch(pcfg, x)
    n = exact["n_det"]
    assert n == len(dets) == as_is["n_det"] == cfg.num_patterns
    tsr = exact["time_synch_ref"][:n]
    np.testing.assert_array_equal(ptrs, tsr[:, 0].astype(int))
    np.testing.assert_array_equal(delays, tsr[:, 1].astype(int))
    np.testing.assert_allclose(torch.stack([d.chan for d in dets]).numpy(),
                               exact["est_chan_freq_p"][:n], atol=1e-12,
                               rtol=0)
    t2 = as_is["time_synch_ref"][:n]
    np.testing.assert_array_equal(ptrs + delays, (t2[:, 0] + t2[:, 1]
                                                  ).astype(int))


def test_kernel_shape_rule():
    """On a CUDA tensor the kernels take nfft a power of two in [16, 4096]
    and m_synch >= 1 within one block's shared memory, else ValueError."""
    cfg = port_cfg(G64)
    assert ktrk.route(cfg) == "warp"
    assert ktrk.route(port_cfg(M2)) == "warp"
    for bad in (dataclasses.replace(cfg, nfft=96, num_synch_bins=94,
                                    num_data_bins=90),
                dataclasses.replace(cfg, synch_dat=(0, 3)),
                dataclasses.replace(cfg, nfft=8192, num_synch_bins=8190)):
        with pytest.raises(ValueError):
            ktrk.route(bad)
    assert ktrk.smem_bytes(cfg, "block") == 2 * 16 * 64 * 8 + 62 * 8
    assert ktrk.smem_bytes(cfg, "warp") == (17 + 1) * 64 * 8


NFFT128 = dataclasses.replace(G64, nfft=128, cp_len=32, num_data_bins=120,
                              num_synch_bins=126)
NFFT256 = dataclasses.replace(G64, nfft=256, cp_len=64, num_data_bins=240,
                              num_synch_bins=254)


@pytest.mark.parametrize("cfg,kind", [
    (G64, "warp"), (NFFT128, "warp"), (M2, "warp"),
    (dataclasses.replace(G64, nfft=16, cp_len=4, num_data_bins=12,
                         num_synch_bins=14), "warp"),
    (NFFT256, "block"), (jparams.LTE1024, "block"), (jparams.LTE2048, "block"),
    (dataclasses.replace(jparams.LTE1024, synch_dat=(2, 2)), "block"),
    (dataclasses.replace(G64, cp_len=64), "block")],
    ids=["golden64", "nfft128", "m_synch2", "nfft16", "nfft256", "lte1024",
         "lte2048", "lte1024-m_synch2", "cp-nfft"])
def test_route_rule(cfg, kind):
    """nfft up to WARP_MAX_NFFT with cp < nfft takes the warp route, larger
    nfft (or cp >= nfft) the block route, whatever m_synch is."""
    assert ktrk.route(port_cfg(cfg)) == kind


@pytest.mark.parametrize("bad", [
    dict(nfft=96, num_synch_bins=94, num_data_bins=90),
    dict(nfft=8, cp_len=2, num_synch_bins=6, num_data_bins=4),
    dict(synch_dat=(0, 3)),
    dict(nfft=128, cp_len=32, num_synch_bins=126, num_data_bins=120,
         synch_dat=(200, 2)),
    dict(nfft=2048, cp_len=512, num_synch_bins=2046, num_data_bins=1200,
         synch_dat=(40, 2))],
    ids=["nfft96", "nfft8", "no-synch", "warp-smem", "block-smem"])
def test_route_raises_where_no_kernel_takes_the_shape(bad):
    cfg = dataclasses.replace(port_cfg(G64), **bad)
    with pytest.raises(ValueError):
        ktrk.route(cfg)


def _steps(cfg, x, steps, carry=None):
    """The plain step run by hand: the carry after, and the step outputs
    stacked (channel rows uncompacted [B, steps, nfft])."""
    step = trk.make_tracker_step(cfg, x, 0, x.shape[1])
    if carry is None:
        carry = trk.tracker_init_carry(x.shape[0], device="cpu")
    ys = []
    for _ in range(steps):
        carry, y = step(carry)
        ys.append(y)
    return carry, [torch.stack(f, 1) for f in zip(*ys)]


def _compacted(acc, rows, max_det):
    """The channel table by its definition: row k the k-th accepted step's
    row, accepted steps past max_det dropped, zero rows after."""
    out = torch.zeros(acc.shape[0], max_det, rows.shape[-1],
                      dtype=rows.dtype)
    for b in range(acc.shape[0]):
        idx = torch.nonzero(acc[b]).reshape(-1)[:max_det]
        out[b, :len(idx)] = rows[b, idx]
    return out


@pytest.mark.parametrize("max_det", [4, 40])
def test_track_scan_plain_returns_the_compacted_table(golden, max_det):
    """track_scan_plain's channel table == emit_channels of the stacked step
    rows of make_tracker_step == the table by its definition, with a
    max_det below the accept count (rows dropped) and above it (zero rows);
    the other outputs and the carry are the steps' own."""
    _, rx = golden
    cfg = port_cfg(G64)
    _, rx2 = _buffer(G64, seed=1)
    x = torch.from_numpy(np.stack([rx, rx2]))
    steps = 12
    c_ref, (acc, ptr, delay, peak, rows) = _steps(cfg, x, steps)
    carry, ys = ktrk.track_scan_plain(cfg, x, 0, x.shape[1],
                                      trk.tracker_init_carry(2, device="cpu"),
                                      steps, max_det)
    assert ys[4].shape == (2, max_det, cfg.nfft)
    n_acc = acc.sum(1)
    assert bool((n_acc > 4).all()) and bool((n_acc < 40).all())
    assert torch.equal(ys[4], trk.emit_channels(acc, rows, max_det))
    assert torch.equal(ys[4], _compacted(acc, rows, max_det))
    for a, b in zip(ys[:4], (acc, ptr, delay, peak)):
        assert torch.equal(a, b)
    for a, b in zip(carry, c_ref):
        assert torch.equal(a, b)


def test_track_scan_plain_count_restarts_each_call(golden):
    """A stream chunk is one call: the second call's table starts at its own
    first accepted step (not at sym_count), as the rows of one long run
    split at the same step."""
    _, rx = golden
    cfg = port_cfg(G64)
    x = torch.from_numpy(rx)[None]
    first, steps, max_det = 5, 12, 8
    _, (acc, *_, rows) = _steps(cfg, x, steps)
    c1, y1 = ktrk.track_scan_plain(cfg, x, 0, x.shape[1],
                                   trk.tracker_init_carry(1, device="cpu"),
                                   first, max_det)
    _, y2 = ktrk.track_scan_plain(cfg, x, 0, x.shape[1], c1, steps - first,
                                  max_det)
    assert int(acc[:, :first].sum()) >= 3 and int(acc[:, first:].sum()) >= 3
    assert int(c1.sym_count) == int(acc[:, :first].sum())
    assert torch.equal(y1[4], _compacted(acc[:, :first], rows[:, :first],
                                         max_det))
    assert torch.equal(y2[4], _compacted(acc[:, first:], rows[:, first:],
                                         max_det))
    assert torch.equal(y2[0], acc[:, first:])


@pytest.mark.parametrize("cfg,kind", [(G64, "warp"), (M2, "warp"),
                                      (NFFT256, "block")],
                         ids=["golden64", "m_synch2", "nfft256"])
def test_wrapper_launches_by_the_route_rule(monkeypatch, cfg, kind):
    """The wrapper's CUDA branch with the launch recorded instead of run:
    the entry point the rule names with as many arguments as its C
    signature, max_det and the block's shared memory passed, the delay
    matrix to the warp route only, the outputs
    shaped [B, steps] and [B, max_det, nfft], one launch counted on that
    route, and the route counts reset with the others."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.kernels import _cuda
    pcfg = port_cfg(cfg)
    calls = []
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "launch",
                        lambda name, dev, *args: calls.append((name, args)))
    kernels.reset_launch_counts()
    assert ktrk.route_launches == {"warp": 0, "block": 0}
    batch, n, steps, max_det = 3, 4000, 40, 7
    x = torch.zeros(batch, n, dtype=torch.complex64)
    carry, ys = ktrk.track_scan(pcfg, x, 0, n,
                                trk.tracker_init_carry(batch, device="cpu"),
                                steps, max_det)
    (name, args), = calls
    assert name == ktrk.ENTRY[kind]
    assert len(args) + 1 == len(_cuda.SIGNATURES[name])
    assert args[7:9] == (steps, max_det)
    assert args[-3] == ktrk.smem_bytes(pcfg, kind)
    assert [tuple(y.shape) for y in ys] == [(batch, steps)] * 4 + [
        (batch, max_det, cfg.nfft)]
    assert ys[4].dtype == torch.complex64
    assert [tuple(c.shape) for c in carry] == [
        tuple(c.shape)
        for c in trk.tracker_init_carry(batch, device="cpu")]
    assert kernels.launch_counts()["tracker"] == 1
    other = "block" if kind == "warp" else "warp"
    assert ktrk.route_launches == {kind: 1, other: 0}
    calls.clear()
    ktrk._launch("block", pcfg, x, 0, n,
                 trk.tracker_init_carry(batch, device="cpu"), steps, max_det)
    ktrk._launch("warp", pcfg, x, 0, n,
                 trk.tracker_init_carry(batch, device="cpu"), steps, max_det)
    assert [c[0] for c in calls] == ["tracker_scan", "tracker_scan_warp"]
    assert [c[1][-3] for c in calls] == [ktrk.smem_bytes(pcfg, "block"),
                                         ktrk.smem_bytes(pcfg, "warp")]
    # the delay matrix: the warp route's table only (the block route gets
    # a null pointer in its slot)
    assert [c[1][12] == 0 for c in calls] == [True, False]
    assert ktrk.route_launches == {kind: 2, other: 1}
    with pytest.raises(ValueError):
        ktrk._launch("grid", pcfg, x, 0, n,
                     trk.tracker_init_carry(batch, device="cpu"), steps,
                     max_det)
    with pytest.raises(ValueError):
        ktrk.track_scan(pcfg, x, 0, n, trk.tracker_init_carry(
            batch, device="cpu")._replace(
            b=torch.zeros(batch, 2, dtype=torch.float64)), steps, max_det)
    kernels.reset_launch_counts()
    assert ktrk.route_launches == {"warp": 0, "block": 0}


def _warp_lanes(nfft):
    """csrc/tracker.cu:Lanes: points a lane, lanes a window, DIF rounds."""
    e = nfft // 32 if nfft >= 64 else 1
    w = nfft // e
    return e, w, w.bit_length() - 1


def _warp_edft(v, e, inverse):
    """The E-point DFT a lane runs on its registers (v [32, E])."""
    if e == 2:
        return np.stack([v[:, 0] + v[:, 1], v[:, 0] - v[:, 1]], 1)
    if e == 4:
        a0, a1 = v[:, 0] + v[:, 2], v[:, 0] - v[:, 2]
        a2, a3 = v[:, 1] + v[:, 3], v[:, 1] - v[:, 3]
        b = (1j if inverse else -1j) * a3
        return np.stack([a0 + a2, a1 + b, a0 - a2, a1 - b], 1)
    return v


@pytest.mark.parametrize("nfft", [16, 32, 64, 128])
def test_warp_route_transforms(nfft):
    """The warp route's transforms (csrc/tracker.cu: Lane::transform,
    Lane::inverse) run in numpy lane by lane, with the float64 twiddle
    table of kernels/fft.py (complex64, hence 1e-5): register e of lane l
    holds bin e + E brev(l) of np.fft.fft of the window, and the inverse of
    a spectrum laid out so holds sum_k q_k e^(+2 pi i k n / nfft) at n = l
    + W e (the correlation at delay n).  The lanes past W (nfft 16) repeat
    lanes 0 to W - 1."""
    from lte_gnu_radio_code_tpu_torch.kernels import fft
    e_n, w_n, logw = _warp_lanes(nfft)
    tw = fft.twiddles(nfft).astype(np.complex128)
    lanes = np.arange(32)
    l = lanes & (w_n - 1)
    brev = np.array([int(format(v, f"0{logw}b")[::-1], 2) for v in l])
    bins = np.arange(e_n)[None, :] + e_n * brev[:, None]        # [32, E]
    w1 = np.stack([tw[l * e] for e in range(e_n)], 1)
    ws = [tw[(l & (h - 1)) * (nfft // (2 * h))]
          for h in (w_n >> (r + 1) for r in range(logw))]
    rng = np.random.default_rng(nfft)
    x = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    v = _warp_edft(x[l[:, None] + w_n * np.arange(e_n)[None, :]], e_n,
                   False) * w1
    for r in range(logw):
        h = w_n >> (r + 1)
        q = v[lanes ^ h]
        v = np.where((l & h)[:, None] != 0, (q - v) * ws[r][:, None], v + q)
    np.testing.assert_allclose(v, np.fft.fft(x)[bins], atol=1e-5)
    spec = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    c = spec[bins]
    for r in reversed(range(logw)):
        h = w_n >> (r + 1)
        up = (l & h)[:, None] != 0
        t = np.where(up, c * np.conj(ws[r])[:, None], c)
        q = t[lanes ^ h]
        c = np.where(up, q - t, t + q)
    c = _warp_edft(c * np.conj(w1), e_n, True)
    n_idx = l[:, None] + w_n * np.arange(e_n)[None, :]
    ref = np.exp(2j * np.pi * np.outer(np.arange(nfft), np.arange(nfft)) /
                 nfft) @ spec
    np.testing.assert_allclose(c, ref[n_idx], atol=1e-5)
    # every bin, and every delay, once among the lanes of a window
    assert sorted(bins[:w_n].ravel()) == list(range(nfft))
    assert sorted(n_idx[:w_n].ravel()) == list(range(nfft))


LTE1024_M2 = dataclasses.replace(jparams.LTE1024, synch_dat=(2, 2))


@pytest.mark.parametrize("cfg", [NFFT256, jparams.LTE1024, jparams.LTE2048,
                                 LTE1024_M2],
                         ids=["nfft256", "lte1024", "lte2048",
                              "lte1024-m_synch2"])
def test_block_route_correlation_is_an_inverse_fft(cfg):
    """The block route's correlation (csrc/tracker.cu:tracker_scan, steps
    3-5) in numpy: q = sum_m sd_norm conj(zc) over the windows, scattered
    to the synch bins (kernels/tracker.py:_tables) in a zeroed row, through
    fft.cuh's inverse stages with the twiddle table of kernels/fft.py
    (complex64), read at d <= cp, equals the JAX step's correlation
    |conj(zc) @ (sd_norm[:, None] p_mat_j)| (its own zc and delay matrix,
    lte_gnu_radio_code_tpu/models/tracker.py:make_tracker_step) within 1e-5
    of the peak, with the same first-index argmax (the sent delay).  The
    accepted step's channel row takes column arg of the delay matrix from
    the twiddles: conj(tw[k arg mod nfft]) == the JAX matrix's column
    (the port's models/tracker.py:delay_matrix is that matrix, bit for
    bit)."""
    from lte_gnu_radio_code_tpu_torch.kernels import fft
    from test_torch_fft_plan import stockham
    jstep = jtrk.make_tracker_step(cfg, jnp.zeros(8, jnp.complex64), 0, 0)
    jvars = inspect.getclosurevars(jstep).nonlocals
    zc_j, p_mat_j = jvars["zc"], jvars["p_mat_j"]
    cfg = port_cfg(cfg)
    tab = ktrk._tables(cfg)
    bins, slot, zc_conj = tab["bins"], tab["slot"], tab["zc_conj"]
    nfft, cp, m0, nsb = cfg.nfft, cfg.cp_len, cfg.m_synch, cfg.num_synch_bins
    assert np.array_equal(np.nonzero(slot >= 0)[0], np.sort(bins))
    rng = np.random.default_rng(nfft + m0)
    d0 = int(rng.integers(1, cp))
    ramp = np.tile(np.exp(-2j * np.pi * bins * d0 / nfft), m0)
    noise = rng.standard_normal((2, m0 * nsb))
    sd = np.conj(zc_conj) * ramp + 0.5 * (noise[0] + 1j * noise[1])
    sd = (sd / np.sqrt(np.mean(np.abs(sd) ** 2))).astype(np.complex64)
    prod = sd * zc_conj
    ref = np.asarray(jnp.abs(jnp.conj(zc_j) @ (jnp.asarray(sd)[:, None] *
                                               p_mat_j)))
    row = np.zeros(nfft, np.complex64)
    row[bins] = prod.reshape(m0, nsb).sum(0)
    got = np.abs(stockham(row, inverse=True))[np.arange(cp + 1) % nfft]
    assert np.abs(got - ref).max() <= 1e-5 * ref.max()
    assert int(np.argmax(got)) == int(np.argmax(ref)) == d0
    tw = fft.twiddles(nfft)
    col = np.conj(tw[(bins.astype(np.int64) * d0) % nfft])
    np.testing.assert_allclose(col, np.asarray(p_mat_j)[:nsb, d0],
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(trk.delay_matrix(cfg), np.asarray(p_mat_j))


def _lte_buffer():
    """A short LTE1024 buffer (_LTE_SHORT, 80 dB) and its config."""
    return _LTE_SHORT, _buffer(_LTE_SHORT)[1]


@pytest.mark.parametrize("case", ["golden64", "lte1024"])
def test_step_that_does_not_fire_is_a_fixed_point(golden, case):
    """What both routes' early exit rests on: along track_scan_plain's step
    (make_tracker_step), every step after the first that does not fire
    (the loop count stays) has that step's carry, bit for bit, and its
    outputs (accept false, pointer, delay, peak, a zero channel row)."""
    if case == "golden64":
        cfg, rx = port_cfg(G64), golden[1]
    else:
        cfg, rx = _lte_buffer()
        cfg = port_cfg(cfg)
    x = torch.from_numpy(rx)[None]
    step = trk.make_tracker_step(cfg, x, 0, x.shape[1])
    carry, fired, frozen = trk.tracker_init_carry(1, device="cpu"), 0, None
    for _ in range(x.shape[1] // trk.tracker_stride(cfg) + 1):
        new, y = step(carry)
        if int(new.loop_count) == int(carry.loop_count):
            frozen = (new, y)
            break
        carry, fired = new, fired + 1
    assert frozen is not None and fired >= cfg.num_patterns
    new, y = frozen
    assert not bool(y[0]) and not bool(y[4].abs().any())
    for a, b in zip(new, carry):
        assert torch.equal(a, b)
    for _ in range(40):
        new, y2 = step(new)
        for a, b in zip(new, carry):
            assert torch.equal(a, b)
        for a, b in zip(y2, y):
            assert torch.equal(a, b)
