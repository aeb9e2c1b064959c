"""The tracker of the PyTorch port on the CPU (``models/tracker.py``, the
plain twin of ``kernels/tracker.py:track_scan`` and
``runtime/stream.py:TrackerStreamingRx``), against the JAX package and its
numpy oracle on seeded buffers.

Exact: every integer carry field and the float32 bits of the history and of
the least-squares ``b`` at every step (``ceil()`` of the prediction decides
a pointer), accepts, pointers, delays, counts and hard bits.  Within
tolerance: peaks 1e-5 of their size (they reach m_synch * num_synch_bins;
the two FFTs round differently), channel estimates 1e-5, phasors 2e-4 (the
JAX package's, tests/test_stream_rx.py).  The kernel is held to its plain
twin on a CUDA device by tests/test_torch_cuda.py."""

import dataclasses

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
from lte_gnu_radio_code_tpu_torch.runtime import stream as rt
from torch_parity import port_cfg

CHAN_ATOL = 1e-5
PH_ATOL = 2e-4
PEAK_RTOL = 1e-5
GAP = 3                  # zero samples inserted mid-stream in the drift case

G64 = jparams.GOLDEN64
M2 = dataclasses.replace(G64, synch_dat=(2, 2), num_ofdm_symb=48).validate()


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


def test_plain_step_carry_bits_equal_jax(golden):
    """Step by step over the GOLDEN64 buffer: the plain step's carry equals
    the JAX carry, the float32 history and b to the bit."""
    _, rx = golden
    steps, jcarries, jys = _jax_scan(G64, rx)
    cfg = port_cfg(G64)
    x = torch.from_numpy(rx)[None]
    step = trk.make_tracker_step(cfg, x, 0, x.shape[1])
    carry = trk.tracker_init_carry(1)
    carries, ys = [], []
    for _ in range(steps):
        carry, y = step(carry)
        carries.append(carry)
        ys.append(y)
    for i, name in enumerate(trk.TrackerCarry._fields):
        ours = torch.stack([c[i][0] for c in carries]).numpy()
        if ours.dtype == np.float32:
            np.testing.assert_array_equal(ours.view(np.int32),
                                          jcarries[i].view(np.int32),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(ours, jcarries[i], err_msg=name)
    acc, ptr, delay, peak, h = (torch.stack([y[k][0] for y in ys]).numpy()
                                for k in range(5))
    for name, ours, ref in (("accept", acc, jys[0]), ("ptr", ptr, jys[1]),
                            ("delay", delay, jys[2])):
        np.testing.assert_array_equal(ours, ref, err_msg=name)
    np.testing.assert_allclose(peak, jys[3], rtol=PEAK_RTOL)
    np.testing.assert_allclose(h, jys[4], atol=CHAN_ATOL)
    # the least-squares predictor took over: pointers came from b
    assert int(acc.sum()) == G64.num_patterns and (jcarries[1] >= 5).any()


@pytest.mark.parametrize("x_max,y_max", [(300, 40000), (4000, 400000)],
                         ids=["frame", "stream"])
def test_masked_lstsq_bits_equal_jax(x_max, y_max):
    """The closed-form fit on integer histories of the sizes a frame gives
    (sxy beyond 2^24, where the order of the sums shows) and a 16-frame
    stream gives (the products x * y round too, and XLA contracts each into
    the running sum).  The first "stream" row is the history after the gap
    of a 16-frame GOLDEN64 stream, where a rounded product moved b1 from
    80.64 to 80.24."""
    rng = np.random.default_rng(5)
    hx = (rng.integers(0, x_max, (64, 5)) * 4).astype(np.float32)
    hy = rng.integers(0, y_max, (64, 5)).astype(np.float32)
    n_eff = rng.integers(0, 6, 64).astype(np.int32)
    if x_max > 300:
        hx[0] = (1200, 1204, 1208, 1212, 1196)
        hy[0] = (96019, 96339, 96659, 96979, 95696)
        n_eff[0] = 5
    ours = trk._masked_lstsq(torch.from_numpy(hx), torch.from_numpy(hy),
                             torch.from_numpy(n_eff)).numpy()
    ref = np.stack([np.asarray(jax.jit(jtrk._masked_lstsq)(
        jnp.asarray(a), jnp.asarray(b), jnp.int32(c)))
        for a, b, c in zip(hx, hy, n_eff)])
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


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


@pytest.mark.parametrize("case", ["golden64", "m_synch2", "drift"])
def test_track_frame_equals_jax(case):
    """Whole buffer: the port's track_frame == the JAX one, on GOLDEN64, an
    m_synch = 2 frame and a GOLDEN64 stream with GAP samples inserted mid
    stream (the tracker re-adjusts; the symbols before the gap decode).
    With m_synch = 2 both packages demodulate the symbol (j + 1) * (nfft +
    cp) after a detection's pointer, the second synch symbol first, as the
    reference's rx_data_demod does: their bits are equal, and about half of
    them differ from the sent ones."""
    cfg = M2 if case == "m_synch2" else G64
    gap_at = 9600 + 37 if case == "drift" else None
    bits, rx = _buffer(cfg, gap_at=gap_at)
    ref = jtrk.make_tracker(cfg, len(rx))(jnp.asarray(rx))
    ours = trk.make_tracker(port_cfg(cfg), len(rx), device="cpu")(rx)
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


def test_kernel_shape_rule():
    """On a CUDA tensor the kernel takes nfft a power of two in [16, 4096]
    and m_synch >= 1 within one block's shared memory, else ValueError."""
    cfg = port_cfg(G64)
    ktrk.require(cfg)
    ktrk.require(port_cfg(M2))
    for bad in (dataclasses.replace(cfg, nfft=96, num_synch_bins=94,
                                    num_data_bins=90),
                dataclasses.replace(cfg, synch_dat=(0, 3)),
                dataclasses.replace(cfg, nfft=8192, num_synch_bins=8190)):
        with pytest.raises(ValueError):
            ktrk.require(bad)
    assert ktrk.smem_bytes(cfg) == 2 * 16 * 64 * 8 + 62 * 8 + 80
