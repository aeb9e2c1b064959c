"""The sharded runtime of the PyTorch port (``parallel/``) on the CPU,
against the JAX package's ``parallel/`` on its virtual 8-device CPU mesh
(tests/conftest.py) and against the port's own single-device receivers, on
numpy inputs made from a seed.

Exact: locks, delays, found flags, hard bits, BER, detection tables (ptrs,
delays, fo_idx, valid, demod_ok) and the carry.  Within tolerance: phasors
and channel estimates 2e-4 against the JAX package, 1e-5 against the
port's single-device RX; peaks 2e-3.  The wrappers' CUDA branches run with
the launch recorded instead of made; the kernels themselves are held to
their plain versions on a CUDA device by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu.models import legacy_rx as jlegacy
from lte_gnu_radio_code_tpu.models import stream_rx as jstream_rx
from lte_gnu_radio_code_tpu.parallel import chain as jpchain
from lte_gnu_radio_code_tpu.parallel import mesh as jmesh
from lte_gnu_radio_code_tpu.parallel import sharded as jsharded
from lte_gnu_radio_code_tpu.parallel import streaming as jstreaming
from lte_gnu_radio_code_tpu.reference_cpu import golden as G
from lte_gnu_radio_code_tpu.utils import params as jparams
from lte_gnu_radio_code_tpu_torch import kernels
from lte_gnu_radio_code_tpu_torch.kernels import _cuda
from lte_gnu_radio_code_tpu_torch.models import chain, rxofdm
from lte_gnu_radio_code_tpu_torch.parallel import chain as pchain
from lte_gnu_radio_code_tpu_torch.parallel import mesh as pmesh
from lte_gnu_radio_code_tpu_torch.parallel import sharded, streaming
from lte_gnu_radio_code_tpu_torch.runtime import stream as rt
from torch_parity import port_cfg, recorded_launch

CFG = jparams.GOLDEN64
PCFG = port_cfg(CFG)
ATOL = 2e-4             # phasors, channel estimates against JAX
PEAK_ATOL = 2e-3
FO_RANGE = (0.0, -1500.0, 1500.0)
CPU = "cpu"


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_same(a, b, what="", atol=ATOL):
    """Two outputs of one NamedTuple layout, from either package: integer
    and bool fields exactly, float fields within tolerance."""
    assert a._fields == b._fields
    for f in a._fields:
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        assert x.shape == y.shape, (what, f, x.shape, y.shape)
        if x.dtype.kind in "fc":
            np.testing.assert_allclose(
                x, y, atol=PEAK_ATOL if f == "peaks" else atol, rtol=0,
                err_msg=f"{what} {f}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")


@pytest.fixture(scope="module")
def rx_buffer():
    """tests/test_sharding.py's buffer: one GOLDEN64 frame through the
    numpy oracle's TX, the Fading channel and AWGN."""
    bits = np.random.default_rng(0).integers(0, 2, CFG.num_bits)
    tx = G.tx_frame(CFG, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=64)
    rx = G.awgn(CFG, rx, np.random.default_rng(1), np.var(tx))
    return bits, rx.astype(np.complex64)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_rx_equals_jax_and_single_device(rx_buffer, n_shards):
    bits, rx = rx_buffer
    j = jsharded.make_sharded_rx(CFG, len(rx), jmesh.time_mesh(n_shards))(
        jnp.asarray(rx))
    mesh = pmesh.time_mesh(n_shards, device=CPU)
    r = sharded.make_sharded_rx(PCFG, len(rx), mesh)(rx)
    one = rxofdm.make_rx(PCFG, len(rx))(torch.from_numpy(rx))
    assert bool(r.found) and bool(j.found)
    for ref in (j, one):
        assert int(r.lock_ptr) == int(ref.lock_ptr)
        assert int(r.delay_idx) == int(ref.delay_idx)
        np.testing.assert_array_equal(r.hard_bits, _np(ref.hard_bits))
    np.testing.assert_array_equal(r.hard_bits, bits)
    np.testing.assert_allclose(r.phasors, np.asarray(j.phasors), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(r.phasors, one.phasors, atol=1e-5, rtol=0)
    np.testing.assert_allclose(r.chan_est_time, np.asarray(j.chan_est_time),
                               atol=ATOL, rtol=0)
    assert abs(float(r.peak) - float(j.peak)) < PEAK_ATOL


def test_sharded_rx_frame_axis_and_no_false_lock():
    """A frame axis: each frame as alone; noise alone locks nowhere, in
    either package."""
    n = CFG.frame_len + CFG.nfft - 1
    noise = 0.05 * (np.random.default_rng(3).standard_normal(n) +
                    1j * np.random.default_rng(4).standard_normal(n))
    noise = noise.astype(np.complex64)
    j = jsharded.make_sharded_rx(CFG, n, jmesh.time_mesh(4))(
        jnp.asarray(noise))
    mesh = pmesh.time_mesh(4, device=CPU)
    r = sharded.make_sharded_rx(PCFG, n, mesh)(noise)
    assert not bool(r.found) and not bool(j.found)
    assert not bool(r.phasors.any()) and int(r.delay_idx) == 0

    bits = np.random.default_rng(5).integers(0, 2, CFG.num_bits)
    frame = G.apply_channel(G.tx_frame(CFG, bits), G.channel_taps("Fading"),
                            max_impulse=64)[:n].astype(np.complex64)
    both = sharded.make_sharded_rx(PCFG, n, mesh)(np.stack([frame, noise]))
    alone = sharded.make_sharded_rx(PCFG, n, mesh)(frame)
    assert both.found.tolist() == [True, False]
    assert torch.equal(both.hard_bits[0], alone.hard_bits)
    assert int(both.lock_ptr[0]) == int(alone.lock_ptr)
    torch.testing.assert_close(both.phasors[0], alone.phasors, atol=1e-6,
                               rtol=0)


def test_dp_t_chain_equals_chain_batch_and_jax_zero_ber():
    """tests/test_sharding.py's dp x t chain: the JAX one is BER 0 with
    every frame locked, and so is the port's, whose BER, found and lock
    equal ``chain_batch``'s on one injected noise tensor."""
    cfg = jparams.OFDMConfig(num_ofdm_symb=48).validate()
    pcfg = port_cfg(cfg)
    b = 4
    bits = np.stack([np.random.default_rng(s).integers(0, 2, cfg.num_bits)
                     for s in range(b)]).astype(np.int32)
    jber, jfound, _ = jpchain.make_sharded_chain(
        cfg, jmesh.make_mesh(8, dp=2, axis_names=("dp", "t")))(
        jnp.asarray(bits), jnp.arange(b, dtype=jnp.int32))
    assert bool(np.asarray(jfound).all())
    assert float(np.asarray(jber).max()) == 0.0

    n = cfg.frame_len + cfg.nfft - 1
    gen = torch.Generator().manual_seed(0)
    noise = torch.complex(torch.randn(b, n, generator=gen),
                          torch.randn(b, n, generator=gen))
    bits = torch.from_numpy(bits)
    step = pchain.make_sharded_chain(
        pcfg, pmesh.make_mesh(8, dp=2, device=CPU))
    ber, found, lock = step(bits, noise=noise)
    n_trials, num_patterns = rxofdm.plan_rx(pcfg, n)
    ref = chain.chain_batch(pcfg, chain.loopback_taps(pcfg), n_trials,
                            num_patterns, bits, noise=noise)
    assert bool(found.all()) and float(ber.max()) == 0.0
    assert torch.equal(ber, ref.ber) and torch.equal(found, ref.found)
    assert torch.equal(lock, ref.lock_ptr)
    # a generator draws the noise as chain_batch draws it
    ber_g, found_g, lock_g = step(bits,
                                  generator=torch.Generator().manual_seed(1))
    ref_g = chain.chain_batch(pcfg, chain.loopback_taps(pcfg), n_trials,
                              num_patterns, bits,
                              generator=torch.Generator().manual_seed(1))
    assert torch.equal(ber_g, ref_g.ber) and torch.equal(lock_g,
                                                         ref_g.lock_ptr)


def _faded(cfg, seed=0):
    bits = np.random.default_rng(seed).integers(0, 2, cfg.num_bits)
    rx = G.apply_channel(G.tx_frame(cfg, bits), G.channel_taps("Fading"))
    return rx.astype(np.complex64)


def _drive(rx, sig, chunk):
    """Every chunk of sig (the last zero-padded, with its real count), then
    finish(): the outputs in order."""
    buf = np.zeros(-(-len(sig) // chunk) * chunk, np.complex64)
    buf[:len(sig)] = sig
    outs = [rx.push(buf[i:i + chunk], n_real=max(0, min(chunk, len(sig) - i)))
            for i in range(0, len(buf), chunk)]
    return outs + rx.finish()


@pytest.mark.parametrize("n_shards,chunk", [(2, 1920), (4, 1920), (8, 4800)])
def test_sharded_reacq_stream_equals_jax_and_unsharded(n_shards, chunk):
    """tests/test_stream_rx.py's sharded stream: every field of every chunk
    against the JAX sharded receiver and the port's unsharded one, the
    carry too, and against the whole-buffer detections."""
    rx = _faded(CFG)
    jrx = jstreaming.ShardedReacqStreamingRx(CFG, chunk,
                                             jmesh.time_mesh(n_shards))
    srx = streaming.ShardedReacqStreamingRx(
        PCFG, chunk, pmesh.time_mesh(n_shards, device=CPU))
    urx = rt.ReacqStreamingRx(PCFG, chunk, device=CPU)
    assert srx.det_max == jrx.det_max == urx.det_max
    outs, jouts, uouts = (_drive(r, rx, chunk) for r in (srx, jrx, urx))
    assert len(outs) == len(jouts) == len(uouts)
    for i, (o, jo, uo) in enumerate(zip(outs, jouts, uouts)):
        _assert_same(o, jo, f"chunk {i} vs JAX")
        _assert_same(o, uo, f"chunk {i} vs unsharded", atol=1e-5)
    for f, v in srx.state._asdict().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jrx.state, f)),
                                      err_msg=f)
    batch = jstream_rx.make_rx_detections(CFG, len(rx))(jnp.asarray(rx))
    nb = int(batch.count)
    v = np.concatenate([o.valid.numpy() for o in outs])
    ptrs = np.concatenate([o.ptrs.numpy() for o in outs])[v]
    hard = np.concatenate([o.hard_bits.numpy() for o in outs])[v]
    keep = ptrs <= int(np.asarray(batch.ptrs[:nb]).max())
    assert nb == CFG.num_patterns
    np.testing.assert_array_equal(ptrs[keep], np.asarray(batch.ptrs[:nb]))
    np.testing.assert_array_equal(hard[keep],
                                  np.asarray(batch.hard_bits[:nb]))


def test_sharded_reacq_push_many_equals_pushes():
    rx = _faded(CFG, seed=2)
    chunk = 1920
    chunks = rx[:len(rx) // chunk * chunk].reshape(-1, chunk)
    mesh = pmesh.time_mesh(4, device=CPU)
    a = streaming.ShardedReacqStreamingRx(PCFG, chunk, mesh)
    b = streaming.ShardedReacqStreamingRx(PCFG, chunk, mesh)
    seq = [a.push(c) for c in chunks]
    many = b.push_many(chunks)
    assert isinstance(many, rt.ReacqChunkOut)
    for f in many._fields:
        assert torch.equal(getattr(many, f),
                           torch.stack([getattr(o, f) for o in seq])), f
    for f, v in a.state._asdict().items():
        assert torch.equal(v, getattr(b.state, f)), f
    assert int(many.valid.sum()) > 0


def _case(table, case):
    return jparams.config_from_case(getattr(jparams, table), case, snr_db=1e8)


def _capture(cfg, seed=0, cfo_hz=0.0, n_frames=1, snr_db=60.0):
    """tests/test_torch_legacy.py's capture: replayed TX frames through the
    Fading channel, a CFO over the whole stream and a little noise."""
    rng = np.random.default_rng(seed)
    frames = [G.apply_channel(G.tx_frame(cfg, rng.integers(0, 2,
                                                           cfg.num_bits)),
                              G.channel_taps("Fading"), max_impulse=cfg.nfft)
              for _ in range(n_frames)]
    sig = np.concatenate(frames)
    if cfo_hz:
        sig = sig * np.exp(1j * 2 * np.pi * cfo_hz / cfg.fs *
                           np.arange(len(sig)))
    nv = 10 ** (-snr_db / 10)
    sig = sig + np.sqrt(nv / 2) * (rng.standard_normal(len(sig)) +
                                   1j * rng.standard_normal(len(sig)))
    return sig.astype(np.complex64)


@pytest.mark.parametrize("table,case,n_shards", [("CFO_CASES", 0, 2),
                                                 ("CFO_CASES", 0, 4),
                                                 ("DSSS_CASES", 4, 2)])
def test_sharded_legacy_stream_equals_jax_and_unsharded(table, case,
                                                        n_shards):
    """tests/test_stream_legacy.py's sharded legacy stream (+1500 Hz, three
    candidates), and once with DSSS: every chunk against the JAX sharded
    receiver and the port's unsharded one, and against the whole-buffer
    receiver on its trial range."""
    cfg = _case(table, case)
    pcfg = port_cfg(cfg)
    is_cfo = table == "CFO_CASES"
    dsss = getattr(jparams, table)[case]["dsss"]
    fo_range = FO_RANGE if is_cfo else (0.0,)
    sig = _capture(cfg, cfo_hz=1500.0 if is_cfo else 0.0, n_frames=2)
    chunk = n_shards * cfg.stride * 24
    kw = dict(fo_range=fo_range, dsss=dsss)
    jrx = jstreaming.ShardedLegacyStreamingRx(cfg, chunk,
                                              jmesh.time_mesh(n_shards), **kw)
    srx = streaming.ShardedLegacyStreamingRx(
        pcfg, chunk, pmesh.time_mesh(n_shards, device=CPU), **kw)
    urx = rt.LegacyStreamingRx(pcfg, chunk, device=CPU, **kw)
    outs, jouts, uouts = (_drive(r, sig, chunk) for r in (srx, jrx, urx))
    for i, (o, jo, uo) in enumerate(zip(outs, jouts, uouts)):
        _assert_same(o, jo, f"chunk {i} vs JAX")
        _assert_same(o, uo, f"chunk {i} vs unsharded", atol=1e-5)
    for f, v in srx.state._asdict().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jrx.state, f)),
                                      err_msg=f)
    batch = jlegacy.make_legacy_rx(cfg, len(sig), max_det=48, **kw)(
        jnp.asarray(sig))
    nb = int(batch.count)
    v = np.concatenate([o.valid.numpy() for o in outs])
    ptrs = np.concatenate([o.ptrs.numpy() for o in outs])[v]
    fo = np.concatenate([o.fo_idx.numpy() for o in outs])[v]
    keep = ptrs <= int(np.asarray(batch.ptrs[:nb]).max())
    assert nb > 0
    np.testing.assert_array_equal(ptrs[keep], np.asarray(batch.ptrs[:nb]))
    np.testing.assert_array_equal(fo[keep], np.asarray(batch.fo_idx[:nb]))
    many = streaming.ShardedLegacyStreamingRx(
        pcfg, chunk, pmesh.time_mesh(n_shards, device=CPU), **kw)
    got = many.push_many(sig[:4 * chunk].reshape(4, chunk))
    for f in got._fields:
        assert torch.equal(getattr(got, f), torch.stack(
            [getattr(o, f) for o in outs[:4]])), f


def test_shapes_that_do_not_split_raise():
    mesh8 = pmesh.time_mesh(8, device=CPU)
    n = CFG.frame_len + CFG.nfft - 1
    small = port_cfg(jparams.OFDMConfig(num_ofdm_symb=8).validate())
    with pytest.raises(ValueError, match="halo"):
        sharded.make_sharded_rx(small, small.frame_len, mesh8)
    with pytest.raises(ValueError, match="halo"):
        pchain.make_sharded_chain(small, pmesh.make_mesh(8, dp=1,
                                                         device=CPU))
    with pytest.raises(ValueError, match="split over dp"):
        pchain.make_sharded_chain(PCFG, pmesh.make_mesh(4, dp=2, device=CPU))(
            torch.zeros(3, PCFG.num_bits, dtype=torch.int32))
    with pytest.raises(ValueError, match="was made for"):
        sharded.make_sharded_rx(PCFG, n, mesh8)(np.zeros(n - 1, np.complex64))
    with pytest.raises(ValueError, match="multiple of n_shards"):
        streaming.ShardedReacqStreamingRx(PCFG, 1924, mesh8)
    with pytest.raises(ValueError, match="lag"):
        streaming.ShardedReacqStreamingRx(PCFG, 960, mesh8)
    legacy = port_cfg(_case("CFO_CASES", 0))
    with pytest.raises(ValueError, match="multiple of n_shards"):
        streaming.ShardedLegacyStreamingRx(legacy, legacy.stride * 25,
                                           pmesh.time_mesh(2, device=CPU))
    with pytest.raises(ValueError, match="lag"):
        streaming.ShardedLegacyStreamingRx(legacy, legacy.stride * 8,
                                           mesh8)
    with pytest.raises(ValueError):
        pmesh.make_mesh(6, dp=4, device=CPU)


def test_meshes_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: pmesh.time_mesh(2, **kw),
                 lambda **kw: pmesh.make_mesh(4, 2, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert make(device=CPU).device.type == CPU
    mesh = pmesh.make_mesh(8, dp=2, device=CPU)
    assert mesh.shape == {"dp": 2, "t": 4} and mesh.group is None


def test_stacked_collectives():
    x = torch.arange(12).reshape(3, 4)
    # JAX perm s -> s + shift: shard s receives shard s - shift's block
    assert pmesh.ppermute(x, 1, 0)[0].tolist() == x[2].tolist()
    assert pmesh.ppermute(x, -1, 0)[2].tolist() == x[0].tolist()
    assert pmesh.psum(x, 0).tolist() == x.sum(0).tolist()
    assert pmesh.pmin(x, 1).tolist() == [0, 4, 8]
    assert pmesh.all_gather(x, 0).tolist() == list(range(12))
    assert pmesh.axis_index(3, CPU).tolist() == [0, 1, 2]


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


def test_sharded_rx_hands_the_kernels_one_launch_each(monkeypatch,
                                                      rx_buffer):
    """One sharded RX call on the kernel path: K4 once over the contiguous
    [t, local + halo] shards, K2 once over every shard's block windows with
    one coefficient row a window; a frame axis goes into the same
    launches."""
    _, rx = rx_buffer
    calls = _record_launches(monkeypatch)
    n_shards = 4
    mesh = pmesh.time_mesh(n_shards, device=CPU)
    local = sharded.padded_len(PCFG, len(rx), n_shards) // n_shards
    slots = local // (PCFG.pattern_len * PCFG.rx_b_len) + 2
    for frames in (1, 3):
        calls.clear()
        sharded.make_sharded_rx(PCFG, len(rx), mesh)(
            np.broadcast_to(rx, (frames, len(rx))).copy())
        assert [name for name, _ in calls] == ["sync_search_direct",
                                               "equalize_fft"]
        search, demod = calls[0][1], calls[1][1]
        assert search[1:3] == (frames * n_shards,
                               local + sharded.halo_size(PCFG))
        assert search[6] == local // PCFG.stride          # trials a shard
        rows = frames * n_shards * slots * PCFG.synch_dat[1]
        assert demod[4] == PCFG.num_data_bins        # one coeff row a window
        assert demod[6:9] == (rows, PCFG.nfft, PCFG.num_data_bins)


@pytest.mark.parametrize("kind", ["reacq", "legacy"])
def test_sharded_step_hands_the_kernels_one_launch_each(monkeypatch, kind):
    """A sharded chunk step on the kernel path: the reacq receiver launches
    K4 once on the contiguous [t, lag + l_loc] tensor and K2 once on
    [t*det_max*nd, nfft] rows; the legacy one K2 alone, on [t*det_max,
    nfft]; the counts say one of each a step."""
    calls = _record_launches(monkeypatch)
    n_shards = 4
    mesh = pmesh.time_mesh(n_shards, device=CPU)
    if kind == "reacq":
        cfg, chunk = PCFG, 1920
        rx = streaming.ShardedReacqStreamingRx(cfg, chunk, mesh)
        lag, want = rt.reacq_lag(cfg), ["sync_search_direct", "equalize_fft"]
        rows = n_shards * rx.det_max * cfg.synch_dat[1]
    else:
        cfg = port_cfg(_case("CFO_CASES", 0))
        chunk = n_shards * cfg.stride * 24
        rx = streaming.ShardedLegacyStreamingRx(cfg, chunk, mesh,
                                                fo_range=FO_RANGE)
        lag, want = rt.legacy_lag(cfg), ["equalize_fft"]
        rows = n_shards * rx.det_max
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, chunk)).astype(np.complex64))
    kernels.reset_launch_counts()
    rx.push_many(x)
    assert [name for name, _ in calls] == want * 2
    if kind == "reacq":
        search = calls[0][1]
        assert search[1:3] == (n_shards, lag + chunk // n_shards)
        assert search[6] == chunk // n_shards // max(1, cfg.stride)
    demod = calls[len(want) - 1][1]
    assert demod[4] == cfg.num_data_bins           # one coeff row a window
    assert demod[6:9] == (rows, cfg.nfft, cfg.num_data_bins)
    counts = kernels.launch_counts()
    assert counts["equalize"] == 2
    assert counts["sync_search"] == (2 if kind == "reacq" else 0)
    assert rx.state.hist.is_contiguous() and rx.state.hist._base is None
    kernels.reset_launch_counts()
