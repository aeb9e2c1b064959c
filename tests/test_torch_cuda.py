"""Each hand-written CUDA kernel of the port against its plain PyTorch twin,
and the loopback chain through them, on a CUDA device; every test skips
without one.  K1 and K2 are held at the shipped configs and at every nfft
their FFT kernels take (16 to 4096); any other nfft raises.  K4's FFT
kernel is held to both plain versions at every such nfft, its direct
kernel at the dense search's sizes and at an nfft that is not a power of
two, and the wrapper to the route rule.  Imports no JAX, so it also runs
on a GPU host that has none (``--noconftest`` skips tests/conftest.py,
which imports jax).  The serving path (``runtime/stream.py``) is held at a
short stream: K4 and K2 at a chunk step's shapes, the receivers on the
kernel path against the plain path, and their CUDA graph path (a full chunk
replays the step captured at the first) against the eager ``reacq_step``
chain, under sync debug mode "error" and the profiler; so is the chain
step's (``chain_batch`` given ``noise=`` replays a graph a configuration
and input shape) against its eager body at the link cells' shapes.  "The
plain path" is the same call on CPU copies of the inputs, where every
wrapper runs its kernel's twin.  The other receiver generations are
held the same way: K2 with the rotation alone against ``torch.fft`` at the
pilot shapes, and the kernel path against the plain path for the QAM chain,
the pilot chain, ``rx_frame_cfo`` and ``LegacyStreamingRx``.  The 2x2
MIMO chains: K4 at ZC slice 0 on both routes, the kernel path against the
plain path, one K4 launch a step, no host synchronisation, at nfft 64 and
at 20 MHz LTE widths (SpMult, the FFT route), and the SpMult detection's
kernel pair against its twin at the three MIMO shapes; a batch of PLS
key exchanges on the card; the native ring's chunks into a receiver on
the card.  The sharded runtime (``parallel/``): the sharded RX, the dp x t
chain and the sharded reacq and legacy chunk steps on the kernels against
the plain path and the unsharded twins, one K4 and one K2 launch a call or
step, a step under sync debug mode "error"; and "t" across 2 processes
(``tests/test_torch_cards.py``'s workers): both on this card over gloo,
and one card each over NCCL where 2 cards are visible.  The stage spans
of ``chain_batch`` and the reacq chunk step (``utils/profiling.py``) add
no device operation and wait for no host:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu_torch import kernels
from lte_gnu_radio_code_tpu_torch.kernels import (_cuda, channel_conv,
                                                  equalize, fft, mimo_detect,
                                                  ofdm_mod, sync_search)
from lte_gnu_radio_code_tpu_torch.models import (chain, legacy_rx, mimo,
                                                 rxofdm, split, stream_rx,
                                                 txofdm)
from lte_gnu_radio_code_tpu_torch.ops import channel, pilots, sync
from lte_gnu_radio_code_tpu_torch.ops.zadoff_chu import zc_for_config
from lte_gnu_radio_code_tpu_torch.runtime import stream as rt
from lte_gnu_radio_code_tpu_torch.utils import profiling
from lte_gnu_radio_code_tpu_torch.utils.params import (CFO_CASES, DSSS_CASES,
                                                       GOLDEN64, LTE1024,
                                                       LTE2048, SDR_PROFILES,
                                                       config_from_case,
                                                       config_from_profile,
                                                       used_bins)
from ofdm_bench.judge import rail_margin

pytestmark = pytest.mark.cuda

G24 = dataclasses.replace(GOLDEN64, num_ofdm_symb=24)
L8 = dataclasses.replace(LTE1024, num_ofdm_symb=8)
M8 = dataclasses.replace(LTE2048, num_ofdm_symb=8)
CFGS = pytest.mark.parametrize("cfg", [G24, L8, M8],
                               ids=["golden64", "lte1024", "lte2048"])


@pytest.fixture
def dev():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU host)")
    return torch.device("cuda")


def _cplx(dev, seed, *shape):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(a.astype(np.complex64)).to(dev)


def _moved(v, dev):
    """v (a tensor, or a tuple or NamedTuple of them) on device dev: a
    call's outputs on CPU copies of its inputs (the plain path) beside the
    card's."""
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    items = [_moved(f, dev) for f in v]
    return type(v)(*items) if hasattr(v, "_fields") else tuple(items)


def _frames(cfg, dev, batch, seed):
    """Seeded frames through the plain TX and the Fading channel."""
    bits = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2, (batch, cfg.num_bits), dtype=np.int32)).to(dev)
    tx = txofdm.tx_frames(cfg, bits)
    return bits, channel.apply_channel(tx, chain.loopback_taps(cfg),
                                       max_impulse=cfg.nfft)


def _route_counts():
    c = kernels.launch_counts()
    return {k: c[k] for k in ("ofdm_mod", "equalize")}


def _k1_check(cfg, grid, vals):
    """K1 on a full grid and on data values against the twin."""
    w = torch.from_numpy(ofdm_mod._idft_mats(cfg.nfft)).to(grid.device)
    torch.testing.assert_close(ofdm_mod.modulate_rows(cfg, grid),
                               ofdm_mod.mod_rows_plain(cfg, grid, w),
                               atol=2e-5, rtol=0)
    _, bins = used_bins(cfg.nfft, cfg.num_data_bins)
    wb = torch.from_numpy(ofdm_mod._idft_bin_mats(cfg.nfft, bins)).to(
        grid.device)
    torch.testing.assert_close(ofdm_mod.modulate_data_vals(cfg, vals, bins),
                               ofdm_mod.mod_rows_plain(cfg, vals, wb),
                               atol=2e-5, rtol=0)


@CFGS
def test_k1_matches_twin(dev, cfg):
    bits, _ = _frames(cfg, dev, 3, seed=1)
    grid = txofdm._grid(cfg, bits).reshape(-1, cfg.nfft)
    before = _route_counts()
    _k1_check(cfg, grid, _cplx(dev, 2, 50, cfg.num_data_bins))
    after = _route_counts()
    assert after == {**before, "ofdm_mod": before["ofdm_mod"] + 2}


@CFGS
@pytest.mark.parametrize("per_row", [False, True], ids=["per-bin", "per-row"])
def test_k2_matches_twin(dev, cfg, per_row):
    win = _cplx(dev, 3, 70, cfg.nfft)
    coeff = _cplx(dev, 4, *((70,) if per_row else ()), cfg.num_data_bins)
    before = _route_counts()
    torch.testing.assert_close(
        equalize.demod_windows(cfg, win, coeff),
        equalize.demod_windows_plain(cfg, win, coeff), atol=2e-4, rtol=0)
    after = _route_counts()
    assert after == {**before, "equalize": before["equalize"] + 1}


@CFGS
def test_k1_k2_zero_rows_give_floor_results(dev, cfg):
    """An all-zero K1 row and K2 window hit the energy and power floors;
    the kernels give the twins' (zero) results, with no NaN."""
    grid = _cplx(dev, 10, 40, cfg.nfft)
    grid[7] = 0
    vals = _cplx(dev, 11, 40, cfg.num_data_bins)
    vals[0] = 0
    _k1_check(cfg, grid, vals)
    out = ofdm_mod.modulate_rows(cfg, grid)
    assert bool(torch.isfinite(out).all()) and not bool(out[7].any())
    win = _cplx(dev, 12, 40, cfg.nfft)
    win[3] = 0
    coeff = _cplx(dev, 13, 40, cfg.num_data_bins)
    got = equalize.demod_windows(cfg, win, coeff)
    torch.testing.assert_close(
        got, equalize.demod_windows_plain(cfg, win, coeff), atol=2e-4,
        rtol=0)
    assert bool(torch.isfinite(got).all()) and not bool(got[3].any())


@pytest.mark.parametrize("nfft", [16, 32, 64, 128, 256, 512, 1024, 2048,
                                  4096])
def test_fft_kernels_at_every_size(dev, nfft):
    """K1 (full grid and bins form) and K2 (per-bin and per-row coeff)
    against their twins at each nfft the FFT kernels take, inputs built
    directly: rows of 4 to 256 threads, one to 64 rows a block, more rows
    than the card holds blocks (so blocks walk the rows and prefetch), an
    all-zero row, and the shared-memory opt-in past 48 KB at 4096."""
    cfg = dataclasses.replace(GOLDEN64, nfft=nfft, cp_len=nfft // 4,
                              num_data_bins=nfft - nfft // 4)
    rows = (1 << 22) // nfft + 3
    grid, win = _cplx(dev, 20, rows, nfft), _cplx(dev, 21, rows, nfft)
    grid[rows // 2] = 0
    win[rows // 3] = 0
    before = _route_counts()
    _k1_check(cfg, grid, _cplx(dev, 22, rows, cfg.num_data_bins))
    for coeff in (_cplx(dev, 23, cfg.num_data_bins),
                  _cplx(dev, 24, rows, cfg.num_data_bins)):
        torch.testing.assert_close(
            equalize.demod_windows(cfg, win, coeff),
            equalize.demod_windows_plain(cfg, win, coeff), atol=2e-4,
            rtol=0)
    assert _route_counts() == {"ofdm_mod": before["ofdm_mod"] + 2,
                               "equalize": before["equalize"] + 2}


def test_other_nfft_raises(dev):
    """nfft 96 is not a power of two: the CUDA wrappers launch nothing and
    raise ValueError (the twins still take it)."""
    cfg = dataclasses.replace(GOLDEN64, nfft=96, cp_len=24)
    assert not fft.takes_fft(cfg.nfft)
    before = _route_counts()
    _, bins = used_bins(cfg.nfft, cfg.num_data_bins)
    with pytest.raises(ValueError):
        ofdm_mod.modulate_rows(cfg, _cplx(dev, 14, 45, cfg.nfft))
    with pytest.raises(ValueError):
        ofdm_mod.modulate_data_vals(
            cfg, _cplx(dev, 15, 45, cfg.num_data_bins), bins)
    with pytest.raises(ValueError):
        equalize.demod_windows(cfg, _cplx(dev, 16, 45, cfg.nfft),
                               _cplx(dev, 17, 45, cfg.num_data_bins))
    assert _route_counts() == before


@pytest.mark.parametrize("name", ["Fading", "IMT16", "Ideal"])
def test_k3_matches_twin(dev, name):
    x = _cplx(dev, 5, 3, 5000)
    h = channel.channel_taps(name)
    out = channel_conv.apply_channel_frames(x, h, 64)
    assert out.shape == (3, 5063)
    torch.testing.assert_close(
        out, channel_conv.apply_channel_frames_plain(x, h, 64), atol=1e-5,
        rtol=0)


K4_TOL = dict(atol=3e-3, rtol=2e-4)   # two summation orders in float32


def _k4_cfg(nfft, stride, m_synch=1):
    cp = nfft // 4
    return dataclasses.replace(
        GOLDEN64, nfft=nfft, cp_len=cp, num_synch_bins=nfft - 2,
        num_data_bins=nfft - nfft // 4, synch_dat=(m_synch, 4 - m_synch),
        stride=cp - 1 if stride is None else stride).validate()


def _k4_check(kind, cfg, x, n_trials):
    """K4's ``kind`` kernel on x [B, n] (row 0 all zero) against the
    conv-bank twin and the FFT-form plain version, both on a zero-padded
    copy so that every trial has its samples; one launch counted on that
    route; 1-D input equal to its row of the batch."""
    before = dict(sync_search.route_launches)
    out = sync_search._launch(kind, cfg, x, n_trials)
    after = dict(sync_search.route_launches)
    assert after == {**before, kind: before[kind] + 1}
    assert out.shape == (x.shape[0], n_trials, cfg.cp_len + 1)
    assert bool(torch.isfinite(out).all()) and not bool(out[0].any())
    need = (cfg.cp_len + n_trials * cfg.stride + cfg.m_synch * cfg.rx_b_len)
    xp = torch.nn.functional.pad(x, (0, max(0, need - x.shape[1])))
    torch.testing.assert_close(
        out, sync_search.sync_corr_abs_plain(cfg, xp, n_trials), **K4_TOL)
    torch.testing.assert_close(
        out, sync_search.sync_corr_abs_fft_plain(cfg, x, n_trials), **K4_TOL)
    torch.testing.assert_close(sync_search._launch(kind, cfg, x[-1], n_trials),
                               out[-1], atol=0, rtol=0)
    torch.testing.assert_close(
        sync_search._launch(kind, cfg, x[-1:], n_trials)[0], out[-1],
        atol=0, rtol=0)
    return out


@CFGS
def test_k4_matches_twin(dev, cfg):
    _, xs = _frames(cfg, dev, 2, seed=6)
    n_trials, _ = rxofdm.plan_rx(cfg, xs.shape[1])
    kind = "direct" if cfg.stride == 1 else "fft"
    assert sync_search.route(cfg.nfft, cfg.cp_len, cfg.stride,
                             cfg.m_synch) == kind
    before = dict(sync_search.route_launches)
    out = sync_search.sync_corr_abs(cfg, xs, n_trials)
    assert sync_search.route_launches == {**before, kind: before[kind] + 1}
    torch.testing.assert_close(
        out, sync_search.sync_corr_abs_plain(cfg, xs, n_trials), atol=3e-3,
        rtol=2e-4)
    torch.testing.assert_close(
        out, sync_search.sync_corr_abs_fft_plain(cfg, xs, n_trials),
        atol=3e-3, rtol=2e-4)
    torch.testing.assert_close(sync_search.sync_corr_abs(cfg, xs[1], n_trials),
                               out[1], atol=0, rtol=0)


K4_FFT_SIZES = pytest.mark.parametrize(
    "nfft,m_synch", [(nfft, m) for nfft in (16, 32, 64, 128, 256, 512, 1024,
                                            2048, 4096) for m in (1, 2)])
K4_DIRECT_SHAPES = pytest.mark.parametrize("nfft,stride,m_synch", [
    (16, 1, 1), (32, 1, 1), (64, 1, 1), (64, 1, 2), (128, 1, 1), (256, 1, 1),
    (96, 1, 1), (96, 23, 1), (64, 15, 1), (64, 16, 2), (1024, 255, 1)])


def _k4_fft_case(dev, nfft, m_synch):
    """Stride cp - 1 (odd, so window starts fall on 8 and on 16 bytes in
    turn; frames of odd length too), three frames with more (frame, trial)
    pairs than the card holds blocks, frame 0 all zero, and trials that run
    past the end of the buffer."""
    cfg = _k4_cfg(nfft, None, m_synch)
    n_trials = max(700, (1 << 18) // cfg.stride)
    n = cfg.cp_len + n_trials * cfg.stride + 1 - (n_trials * cfg.stride) % 2
    assert n % 2 == 1
    x = _cplx(dev, 30 + m_synch, 3, n)
    x[0] = 0
    return cfg, x, n_trials


def _k4_direct_case(dev, nfft, stride, m_synch):
    """Three frames, frame 0 all zero, trials past the buffer."""
    cfg = _k4_cfg(nfft, stride, m_synch)
    n_trials = 3000 // stride + 40
    n = cfg.cp_len + (n_trials - 30) * stride + cfg.m_synch * cfg.rx_b_len + 1
    x = _cplx(dev, 40, 3, n)
    x[0] = 0
    return cfg, x, n_trials


def _k4_peaks_check(kind, cfg, x, n_trials, zc=None):
    """K4's ``kind`` kernel in the peaks form on x [B, n] against the same
    kernel's surface reduced by max(-1): peak and delay bit for bit, the
    delay int32; one launch counted on that route, in the peaks form; 1-D
    input equal to its row of the batch.  Returns (surface, peak, delay)."""
    surface = sync_search._launch(kind, cfg, x, n_trials, zc)
    routes, peaks = (dict(sync_search.route_launches),
                     dict(sync_search.peak_launches))
    peak, delay = sync_search._launch(kind, cfg, x, n_trials, zc,
                                      form="peaks")
    assert sync_search.route_launches == {**routes, kind: routes[kind] + 1}
    assert sync_search.peak_launches == {**peaks, kind: peaks[kind] + 1}
    assert peak.shape == delay.shape == (x.shape[0], n_trials)
    assert peak.dtype == torch.float32 and delay.dtype == torch.int32
    want, at = surface.max(-1)
    assert torch.equal(peak.view(torch.int32), want.view(torch.int32))
    assert torch.equal(delay, at.to(torch.int32))
    one = sync_search._launch(kind, cfg, x[-1], n_trials, zc, form="peaks")
    assert torch.equal(one[0], peak[-1]) and torch.equal(one[1], delay[-1])
    return surface, peak, delay


@K4_FFT_SIZES
def test_k4_fft_route_at_every_size(dev, nfft, m_synch):
    """The FFT kernel at each nfft it takes, one and two synch symbols
    (:func:`_k4_fft_case`)."""
    _k4_check("fft", *_k4_fft_case(dev, nfft, m_synch))


@K4_DIRECT_SHAPES
def test_k4_direct_route(dev, nfft, stride, m_synch):
    """The direct kernel at the dense search's sizes (one delay tile of 17
    up to four at nfft 256), at nfft 96 (not a power of two), and strided
    (odd and even strides; at nfft 1024 a block's trials are cut to the
    span that fits in shared memory), with trials past the buffer."""
    _k4_check("direct", *_k4_direct_case(dev, nfft, stride, m_synch))


@K4_FFT_SIZES
def test_k4_peaks_fft_route_at_every_size(dev, nfft, m_synch):
    """The FFT kernel's peaks form == its surface's max(-1) at every size
    (the row's (value, index) reduction within a warp up to nfft 128,
    across warps above); frame 0, all zero, ties at every delay: peak 0,
    delay 0."""
    _, peak, delay = _k4_peaks_check("fft", *_k4_fft_case(dev, nfft,
                                                          m_synch))
    assert not bool(peak[0].any()) and not bool(delay[0].any())


@K4_DIRECT_SHAPES
def test_k4_peaks_direct_route(dev, nfft, stride, m_synch):
    """The direct kernel's peaks form == its surface's max(-1) at the
    surface test's shapes: cp + 1 > 17 at nfft 96, 128, 256 and 1024, where
    one block walks 2 to 16 delay tiles (the surface form takes one tile a
    block); frame 0 all zero: peak 0, delay 0."""
    _, peak, delay = _k4_peaks_check("direct", *_k4_direct_case(
        dev, nfft, stride, m_synch))
    assert not bool(peak[0].any()) and not bool(delay[0].any())


@pytest.mark.parametrize("kind,nfft,stride", [
    ("direct", 64, 1), ("direct", 128, 1), ("fft", 128, 31)])
def test_k4_peaks_planted_delay_tie(dev, kind, nfft, stride):
    """A ZC sequence zero off the synch bins that are multiples of 4 makes
    K_d repeat with period nfft / 4 = cp: delays 0 and cp of a trial take
    equal values, and where they are the trial's peak the peaks form gives
    delay 0, as max(-1) does.  At nfft 128 delay cp = 32 lies in the
    direct kernel's second delay tile."""
    cfg = _k4_cfg(nfft, stride)
    bins = np.asarray(used_bins(cfg.nfft, cfg.num_synch_bins)[1])
    zc = zc_for_config(cfg) * (bins % 4 == 0)
    n_trials = 4000 // stride
    x = _cplx(dev, 44, 2, cfg.cp_len + n_trials * stride + cfg.rx_b_len)
    surface, peak, delay = _k4_peaks_check(kind, cfg, x, n_trials, zc=zc)
    cp = cfg.cp_len
    tie = (surface[..., 0] == surface[..., cp]) & (surface[..., 0] == peak)
    assert bool(tie.any())
    assert not bool(delay[tie].any())


def test_k4_wrapper_follows_the_rule(dev):
    """nfft 96 goes to the direct kernel through the wrapper; a shape
    neither kernel takes raises and launches nothing."""
    cfg = _k4_cfg(96, 23)
    x = _cplx(dev, 41, 2, 6001)
    before = dict(sync_search.route_launches)
    out = sync_search.sync_corr_abs(cfg, x, 200)
    assert sync_search.route_launches == {**before,
                                          "direct": before["direct"] + 1}
    torch.testing.assert_close(
        out, sync_search.sync_corr_abs_plain(cfg, x, 200), **K4_TOL)
    with pytest.raises(ValueError):
        sync_search._launch("fft", cfg, x, 200)
    big = dataclasses.replace(GOLDEN64, nfft=32768, cp_len=8192,
                              num_synch_bins=32766, stride=8191)
    with pytest.raises(ValueError):
        sync_search.sync_corr_abs(big, _cplx(dev, 42, 1, 70000), 2)
    assert sync_search.route_launches == {**before,
                                          "direct": before["direct"] + 1}


def test_chain_batch_searches_in_the_peaks_form(dev):
    """One GOLDEN64 ``chain_batch`` step, its eager body (what a graph
    captures), launches K4 once, on the direct route, in the peaks form:
    the [B, trials, 17] surface is never written."""
    cfg = GOLDEN64
    n_samples = cfg.frame_len + cfg.nfft - 1
    n_trials, num_patterns = rxofdm.plan_rx(cfg, n_samples)
    bits, _ = _frames(cfg, dev, 4, seed=9)
    kernels.reset_launch_counts()
    r = chain._chain_batch_eager(cfg, chain.loopback_taps(cfg), n_trials,
                                 num_patterns, bits,
                                 noise=_cplx(dev, 10, 4, n_samples))
    assert kernels.launch_counts()["sync_search"] == 1
    assert sync_search.route_launches == {"fft": 0, "direct": 1}
    assert sync_search.peak_launches == {"fft": 0, "direct": 1}
    assert bool(r.found.all()) and float(r.ber.max()) == 0.0


def _bitwise(t):
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("cfg,batch", [(GOLDEN64, 512), (LTE2048, 32)],
                         ids=["golden64-b512", "lte2048-b32"])
@pytest.mark.parametrize("snr_db", [6.0, 24.0])
def test_chain_batch_peaks_form_as_surface_lock(dev, monkeypatch, cfg, batch,
                                                snr_db):
    """``chain_batch`` on K4's peaks form == its eager body with the search
    on the surface form reduced by ``max(-1)`` (the lock the path took
    before the peaks form), every output field bit for bit, at the link
    cells' shapes: each decision of the peaks path is the surface's.  The
    eager body runs the patched search on every call, where a cached
    graph would replay the peaks form it captured."""
    cfg = dataclasses.replace(cfg, snr_db=snr_db).validate()
    n = cfg.frame_len + cfg.nfft - 1
    n_trials, num_patterns = rxofdm.plan_rx(cfg, n)
    g = torch.Generator(device=dev).manual_seed(1234)
    bits = torch.randint(0, 2, (batch, cfg.num_bits), generator=g,
                         device=dev, dtype=torch.int32)
    ri = torch.randn((2, batch, n), generator=g, device=dev)
    noise = torch.complex(ri[0], ri[1])

    def step(run=chain.chain_batch):
        return run(cfg, chain.loopback_taps(cfg), n_trials, num_patterns,
                   bits, noise=noise)

    def surface_peaks(cfg, x, n_trials, zc=None):
        peak, delay = sync_search.sync_corr_abs(cfg, x, n_trials, zc).max(-1)
        return peak, delay.to(torch.int32)

    kernels.reset_launch_counts()
    r = step()
    assert sync_search.peak_launches[sync_search.route(
        cfg.nfft, cfg.cp_len, cfg.stride, cfg.m_synch)] == 1
    monkeypatch.setattr(sync_search, "sync_peaks", surface_peaks)
    kernels.reset_launch_counts()
    s = step(chain._chain_batch_eager)
    assert sync_search.peak_launches == {"fft": 0, "direct": 0}
    for field in r._fields:
        a, b = getattr(r, field), getattr(s, field)
        assert a.shape == b.shape and torch.equal(_bitwise(a),
                                                  _bitwise(b)), field


def test_chain_batch_through_kernels(dev):
    cfg = G24
    n_samples = cfg.frame_len + cfg.nfft - 1
    n_trials, num_patterns = rxofdm.plan_rx(cfg, n_samples)
    bits, _ = _frames(cfg, dev, 4, seed=7)
    noise = _cplx(dev, 8, 4, n_samples)
    h = chain.loopback_taps(cfg)
    kernels.reset_launch_counts()
    r = chain.chain_batch(cfg, h, n_trials, num_patterns, bits, noise=noise)
    counts = kernels.launch_counts()
    assert counts == {**dict.fromkeys(kernels.KERNEL_MODULES, 1),
                      "tracker": 0, "mimo_detect": 0}, counts
    assert bool(r.found.all()) and float(r.ber.max()) == 0.0
    p = _moved(chain.chain_batch(cfg, h, n_trials, num_patterns, bits.cpu(),
                                 noise=noise.cpu()), dev)
    assert torch.equal(r.hard_bits, p.hard_bits)


LINK = pytest.mark.parametrize("cfg,batch", [(GOLDEN64, 512),
                                             (LTE2048, 32)],
                               ids=["golden64-b512", "lte2048-b32"])


def _link_steps(cfg, batch, dev):
    """Two SNR points (6 and 24 dB) by two input sets of seeded bits and
    unit noise made on the card, stepped in turn as the link cells step:
    (h, n_trials, num_patterns, [(cfg, bits, noise)] x 4)."""
    n = cfg.frame_len + cfg.nfft - 1
    n_trials, num_patterns = rxofdm.plan_rx(cfg, n)
    g = torch.Generator(device=dev).manual_seed(2101)
    sets = []
    for _ in range(2):
        bits = torch.randint(0, 2, (batch, cfg.num_bits), generator=g,
                             device=dev, dtype=torch.int32)
        ri = torch.randn((2, batch, n), generator=g, device=dev)
        sets.append((bits, torch.complex(ri[0], ri[1])))
    cfgs = [dataclasses.replace(cfg, snr_db=s).validate() for s in (6., 24.)]
    steps = [(c, b, z) for b, z in sets for c in cfgs]
    return chain.loopback_taps(cfg), n_trials, num_patterns, steps


def _grown(before):
    return {k: n - before[k] for k, n in kernels.launch_state().items()}


@LINK
def test_chain_graph_replays_equal_the_eager_body(dev, cfg, batch):
    """At the link cells' shapes, two SNR points by two input sets in turn
    (a graph each SNR point): every output field of a replayed
    ``chain_batch`` == the eager body's on the same inputs, bit for bit;
    an earlier step's outputs unchanged after the later replays; each
    replay raises ``launch_counts()``, ``route_launches`` and
    ``peak_launches`` by one eager step's launches, one of each kernel."""
    h, n_trials, num_patterns, steps = _link_steps(cfg, batch, dev)
    for c, bits, noise in steps[:2]:                      # the captures
        chain.chain_batch(c, h, n_trials, num_patterns, bits, noise=noise)
    outs, kept, grown = [], [], []
    for c, bits, noise in steps * 2:
        before = kernels.launch_state()
        outs.append(chain.chain_batch(c, h, n_trials, num_patterns, bits,
                                      noise=noise))
        grown.append(_grown(before))
        kept.append(type(outs[-1])(*(f.clone() for f in outs[-1])))
    route = sync_search.route(cfg.nfft, cfg.cp_len, cfg.stride, cfg.m_synch)
    want = {**dict.fromkeys(kernels.launch_state(), 0),
            **{(m, "launches", None): 1 for m in ("ofdm_mod", "channel_conv",
                                                  "sync_search", "equalize")},
            ("sync_search", "route_launches", route): 1,
            ("sync_search", "peak_launches", route): 1}
    for i, (c, bits, noise) in enumerate(steps * 2):
        before = kernels.launch_state()
        ref = chain._chain_batch_eager(c, h, n_trials, num_patterns, bits,
                                       noise=noise)
        assert grown[i] == _grown(before) == want, i
        for field in ref._fields:
            a, b = getattr(outs[i], field), getattr(ref, field)
            assert a.shape == b.shape and torch.equal(
                _bitwise(a), _bitwise(b)), (i, field)
            assert torch.equal(_bitwise(a), _bitwise(getattr(kept[i],
                                                              field)))
    assert bool(outs[-1].found.all())


@LINK
def test_chain_graph_replay_waits_for_no_host(dev, cfg, batch):
    """Replayed steps under sync debug mode "error" and torch.profiler:
    nothing waits for the host, the trace holds K4 by name once a step,
    and ``ofdm.graph_steps`` keeps 1 a replay and 0 a ``generator=``
    step, which runs eagerly."""
    from torch.profiler import ProfilerActivity, profile
    h, n_trials, num_patterns, steps = _link_steps(cfg, batch, dev)
    for c, bits, noise in steps[:2]:                      # the captures
        chain.chain_batch(c, h, n_trials, num_patterns, bits, noise=noise)
    gen = torch.Generator(device=dev).manual_seed(5)
    torch.cuda.synchronize()
    profiling.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                for c, bits, noise in steps:
                    chain.chain_batch(c, h, n_trials, num_patterns, bits,
                                      noise=noise)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            c, bits, _ = steps[0]
            chain.chain_batch(c, h, n_trials, num_patterns, bits,
                              generator=gen)
            torch.cuda.synchronize()
        assert profiling.kept("ofdm.graph_steps") == [1, 1, 1, 1, 0]
    finally:
        profiling.reset_counters()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len([n for n in names if "sync_search_" in n]) == 5, names
    assert sum(e.name == "ofdm.chain_step" and
               e.device_type == torch.autograd.DeviceType.CPU
               for e in prof.events()) == 5


SERVING = pytest.mark.parametrize("cfg,chunk", [
    (GOLDEN64, 65520), (LTE1024, 65280), (LTE2048, 130816)],
    ids=["golden64", "lte1024", "lte2048"])


def _streams(cfg, dev, batch, n, seed):
    """batch continuous streams of n samples: frames of seeded bits through
    the plain TX and one Fading convolution, concatenated."""
    frames = -(-n // cfg.frame_len)
    bits = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2, (batch * frames, cfg.num_bits), dtype=np.int32)).to(dev)
    tx = txofdm.tx_frames(cfg, bits).reshape(batch, -1)
    return channel.apply_channel(tx, chain.loopback_taps(cfg),
                                 max_impulse=cfg.nfft)[:, :n].contiguous()


@SERVING
def test_k4_k2_at_the_serving_shapes(dev, cfg, chunk):
    """One chunk step's kernels at the serving shapes: K4 on ext [4, lag +
    chunk] against both plain versions, and K2 on the step's own
    [4*det_max*nd, nfft] windows with one coefficient row per window, most
    of them empty slots (pointer 0, zero coefficient)."""
    lag, det_max = rt.reacq_lag(cfg), rt.reacq_det_max(cfg, chunk)
    ext = _streams(cfg, dev, 4, lag + chunk, seed=21)
    t_per = chunk // cfg.stride
    out = sync_search.sync_corr_abs(cfg, ext, t_per)
    torch.testing.assert_close(
        out, sync_search.sync_corr_abs_plain(cfg, ext, t_per), **K4_TOL)
    torch.testing.assert_close(
        out, sync_search.sync_corr_abs_fft_plain(cfg, ext, t_per), **K4_TOL)
    dmax_val, dmax_ind = out.max(-1)
    ptrs = cfg.cp_len + cfg.stride * torch.arange(t_per, device=dev)
    _, (l_ptrs, delays), count, _ = sync.refractory_table(
        cfg, dmax_val > sync.gate_level(cfg), (ptrs, dmax_ind), det_max,
        cfg.cp_len)
    valid = torch.arange(det_max, device=dev) < count[:, None]
    assert 0 < int(count.min()) and int(count.max()) < det_max
    _, _, dwin, coeff = stream_rx.detection_rows(
        cfg, ext, l_ptrs, delays, valid, ext.shape[-1])
    nd, nb = cfg.synch_dat[1], cfg.num_data_bins
    win = dwin.reshape(-1, cfg.nfft)
    rows = coeff[:, :, None, :].expand(4, det_max, nd, nb).reshape(
        -1, nb).contiguous()
    k2 = equalize.demod_windows(cfg, win, rows)
    assert k2.shape == (4 * det_max * nd, nb)
    torch.testing.assert_close(
        k2, equalize.demod_windows_plain(cfg, win, rows), atol=2e-4, rtol=0)
    empty = ~valid[:, :, None].expand(4, det_max, nd).reshape(-1)
    assert bool(empty.any()) and not bool(k2[empty].any())


@pytest.mark.parametrize("cfg,chunk", [(GOLDEN64, 4800), (L8, 255 * 64),
                                       (M8, 511 * 32)],
                         ids=["golden64", "lte1024", "lte2048"])
def test_serving_kernel_path_equals_plain_path(dev, cfg, chunk):
    """A short stream through the receivers as a user builds them (on the
    card, kernel paths by default): one K4 and one K2 launch a step
    whatever the number of streams; pointers, delays, masks and hard bits
    equal the plain path's (CPU copies), phasors and channel estimates
    within 2e-4; push_many == pushes; one stream alone == its row."""
    k, batch = 4, 3
    chunks = _streams(cfg, dev, batch, k * chunk, seed=22).reshape(
        batch, k, chunk).transpose(0, 1).contiguous()
    rx = rt.BatchReacqStreamingRx(cfg, chunk, batch)
    assert rx.device.type == "cuda"
    kernels.reset_launch_counts()
    many = rx.push_many(chunks)
    tail = rx.finish()
    counts = kernels.launch_counts()
    assert counts["sync_search"] == counts["equalize"] == k + len(tail)
    assert int(many.valid.sum()) >= batch * (k * chunk // (
        cfg.pattern_len * cfg.rx_b_len) - 2)
    plain = _moved(rt.BatchReacqStreamingRx(
        cfg, chunk, batch, device="cpu").push_many(chunks.cpu()), dev)
    assert kernels.launch_counts() == counts
    for name in ("ptrs", "delays", "valid", "demod_ok", "hard_bits"):
        assert torch.equal(getattr(many, name), getattr(plain, name)), name
    torch.testing.assert_close(many.phasors, plain.phasors, atol=2e-4, rtol=0)
    torch.testing.assert_close(many.chans, plain.chans, atol=2e-4, rtol=0)
    seq = rt.BatchReacqStreamingRx(cfg, chunk, batch)
    for i, c in enumerate(chunks):
        out = seq.push(c)
        for name in out._fields:
            assert torch.equal(getattr(out, name), getattr(many, name)[i])
    one = rt.ReacqStreamingRx(cfg, chunk).push_many(chunks[:, 1])
    for name in ("ptrs", "delays", "valid", "demod_ok", "hard_bits"):
        assert torch.equal(getattr(one, name), getattr(many, name)[:, 1])
    torch.testing.assert_close(one.phasors, many.phasors[:, 1], atol=2e-5,
                               rtol=0)


def _eager_reacq_chain(rx, steps):
    """The functional ``reacq_step`` on rx's kernel paths, eagerly, from an
    empty carry over steps [(chunk, n_real)]: (outputs, final carry, the
    launch counters' growth)."""
    state = rt.reacq_init(rx.cfg, rx.device, rx.batch)
    before = kernels.launch_state()
    outs = []
    for c, n in steps:
        state, out = rt.reacq_step(rx.cfg, state, c, n, rx.det_max)
        outs.append(out)
    after = kernels.launch_state()
    return outs, state, {k: v - before[k] for k, v in after.items()}


def _same_step(a, b, what):
    """Decisions equal, floats within 2e-6 (the same kernels run)."""
    for name in ("ptrs", "delays", "valid", "demod_ok", "hard_bits"):
        assert torch.equal(getattr(a, name), getattr(b, name)), (what, name)
    for name in ("phasors", "chans"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   atol=2e-6, rtol=0, msg=f"{what} {name}")
    torch.testing.assert_close(a.peaks, b.peaks, atol=0, rtol=2e-6)


@SERVING
def test_graph_pushes_equal_the_eager_chain(dev, cfg, chunk):
    """A receiver at a serving chunk: full chunks replay its CUDA graph, a
    partial chunk and the flush step eagerly, all on one carry updated in
    place; every step == the functional ``reacq_step`` chain run eagerly,
    step i's outputs unchanged after step i+1, the launch counters grown
    as by the eager chain."""
    k, batch, n_last = 4, 4, chunk // 3
    x = _streams(cfg, dev, batch, (k + 1) * chunk, seed=31)
    x[:, k * chunk + n_last:] = 0
    chunks = x.reshape(batch, k + 1, chunk).transpose(0, 1)   # strided views
    rx = rt.BatchReacqStreamingRx(cfg, chunk, batch)
    carry = list(rx.state)
    kernels.reset_launch_counts()
    outs, kept = [], []
    for c in chunks[:k]:
        outs.append(rx.push(c))
        kept.append(type(outs[-1])(*(f.clone() for f in outs[-1])))
    outs.append(rx.push(chunks[k], n_real=n_last))
    outs += rx.finish()
    counts = kernels.launch_state()
    assert all(a is b for a, b in zip(rx.state, carry))
    zero = torch.zeros_like(chunks[0])
    steps = ([(c, chunk) for c in chunks[:k]] + [(chunks[k], n_last)] +
             [(zero, 0)] * (len(outs) - k - 1))
    kernels.reset_launch_counts()
    ref, ref_state, ref_counts = _eager_reacq_chain(rx, steps)
    assert counts == ref_counts
    assert counts["sync_search", "launches", None] == len(outs)
    for i, (o, r) in enumerate(zip(outs, ref, strict=True)):
        _same_step(o, r, f"step {i}")
    for i, (o, r) in enumerate(zip(outs[:k], kept)):
        for name in o._fields:
            assert torch.equal(getattr(o, name), getattr(r, name)), (i, name)
    for a, b in zip(rx.state, ref_state):
        assert torch.equal(a, b)
    assert int(sum(o.valid.sum() for o in outs)) > 0


@SERVING
def test_graph_step_traces_its_kernels_without_a_host_sync(dev, cfg, chunk):
    """Replayed chunk steps under torch.profiler and sync debug mode
    "error": nothing waits for the host, the trace holds K4's and K2's
    kernels by name as device events of the replay, and the step keeps its
    counters (``ofdm.graph_steps`` 1 a step, the detections as the
    outputs hold them)."""
    from torch.profiler import ProfilerActivity, profile
    batch = 4
    chunks = _streams(cfg, dev, batch, 3 * chunk, seed=32).reshape(
        batch, 3, chunk).transpose(0, 1)
    rx = rt.BatchReacqStreamingRx(cfg, chunk, batch)
    rx.push(chunks[0])                                    # the capture
    torch.cuda.synchronize()
    profiling.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                outs = [rx.push(c) for c in chunks[1:]]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        assert profiling.kept("ofdm.graph_steps") == [1, 1]
        assert profiling.counters()["ofdm.detections"] == (
            int(sum(o.valid.sum() for o in outs)), 2)
    finally:
        profiling.reset_counters()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    k4 = [n for n in names if "sync_search_" in n]
    k2 = [n for n in names if "equalize_fft" in n]
    assert len(k4) == len(k2) == 2, (k4, k2)
    assert any(e.name == "ofdm.chunk_step" for e in prof.events())


def _device_ops(fn, root) -> int:
    """Device kernels, copies and fills of one fn() in a torch.profiler
    trace, fn() run under sync debug mode "error"; the trace is taken
    again where it lost device events (fewer than the host's launch
    calls), up to four times.  Asserts that the trace holds ``root`` on
    the host exactly where the stage spans are on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    launch = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        events = prof.events()
        seen = sum(e.device_type == DeviceType.CUDA and
                   not getattr(e, "is_user_annotation", False)
                   for e in events)
        made = sum(e.device_type == DeviceType.CPU and
                   e.name.startswith(launch) for e in events)
        if seen >= made:
            break
    spans = profiling.span is not _no_span
    assert any(e.name == root for e in events) == spans
    return seen


def _no_span(name):
    return contextlib.nullcontext()


@pytest.mark.parametrize("step", ["chain", "stream"])
def test_stage_spans_add_no_device_op_and_no_host_sync(dev, step,
                                                       monkeypatch):
    """The two benchmarked steps (``chain_batch``; a
    ``BatchReacqStreamingRx`` chunk step) under the profiler and sync debug
    mode "error": nothing waits for the host, and the device operations
    with the stage spans are as many as with ``profiling.span`` a no-op."""
    if step == "chain":
        cfg = G24
        n = cfg.frame_len + cfg.nfft - 1
        n_trials, num_patterns = rxofdm.plan_rx(cfg, n)
        bits, _ = _frames(cfg, dev, 4, seed=7)
        noise = _cplx(dev, 8, 4, n)
        h = chain.loopback_taps(cfg)
        root = "ofdm.chain_step"

        def fn():
            chain.chain_batch(cfg, h, n_trials, num_patterns, bits,
                              noise=noise)
    else:
        chunk, batch = 4800, 3
        chunks = _streams(GOLDEN64, dev, batch, 8 * chunk, seed=22).reshape(
            batch, 8, chunk).transpose(0, 1).contiguous()
        rx = rt.BatchReacqStreamingRx(GOLDEN64, chunk, batch)
        pushed = iter(chunks)
        root = "ofdm.chunk_step"

        def fn():
            rx.push(next(pushed))
    fn()                                       # the first call builds
    torch.cuda.synchronize()
    with_spans = _device_ops(fn, root)
    monkeypatch.setattr(profiling, "span", _no_span)
    assert with_spans == _device_ops(fn, root) > 0


def test_single_lock_stream_on_the_card(dev):
    """StreamingRx with no device: locks, and the first frame's blocks come
    out once, through one K4 and one K2 launch a step."""
    cfg = GOLDEN64
    bits, xs = _frames(cfg, dev, 1, seed=23)
    chunk = 4800
    buf = torch.zeros(5 * chunk, dtype=torch.complex64, device=dev)
    buf[:xs.shape[1]] = xs[0]
    rx = rt.StreamingRx(cfg, chunk)
    kernels.reset_launch_counts()
    outs = [rx.push(c) for c in buf.reshape(5, chunk)] + [rx.finish()]
    assert kernels.launch_counts()["sync_search"] == 6
    assert kernels.launch_counts()["equalize"] == 6
    ids = torch.cat([o.block_ids for o in outs])
    assert sorted(ids[ids >= 0].tolist()) == list(range(cfg.num_patterns))
    ph = torch.cat([o.phasors for o in outs])[ids >= 0]
    order = ids[ids >= 0].argsort()
    hard = stream_rx.hard_decide(cfg, ph[order]).reshape(-1)
    assert bool(outs[-1].found) and int(outs[-1].lock_ptr) == 16
    assert torch.equal(hard, bits[0])


def test_cli_loopback_runs_on_the_card(dev):
    """The entry point with no --device: one frame through the kernels."""
    from lte_gnu_radio_code_tpu_torch.cli import ofdm_chain
    kernels.reset_launch_counts()
    out = ofdm_chain.main(["--json"])
    assert out == {"found": True, "lock_ptr": 16, "delay_idx": 1,
                   "ber": 0.0}
    assert kernels.launch_counts() == {
        **dict.fromkeys(kernels.KERNEL_MODULES, 1), "tracker": 0,
        "mimo_detect": 0}


PILOT_CFGS = pytest.mark.parametrize("cfg", [
    dataclasses.replace(G24, modulation="QAM16", pilot_grid="lte",
                        pilot_spacing=4),
    dataclasses.replace(G24, pilot_grid="random", ref_sigs=0.3),
    dataclasses.replace(L8, modulation="QAM64", pilot_grid="lte",
                        pilot_spacing=6)],
    ids=["golden64-lte4", "golden64-random", "lte1024-lte6"])


@PILOT_CFGS
def test_k2_with_the_rotation_alone_equals_torch_fft(dev, cfg):
    """The pilot equaliser's K2 call: the windows of four frames at their
    locks with a unit-modulus rotation row a window against torch.fft +
    power norm + rotation, and the whole pilot equaliser against its plain
    path."""
    _, xs = _frames(cfg, dev, 4, seed=31)
    n_trials, num_patterns = rxofdm.plan_rx(cfg, xs.shape[1])
    ptr, delay, _, found, _ = sync.lock_from_peaks(
        cfg, *sync_search.sync_peaks(cfg, xs, n_trials))
    assert bool(found.all())
    win = equalize.data_windows(cfg, xs, ptr, num_patterns)
    rot = equalize.derotation(cfg, delay, dev)
    kernels.reset_launch_counts()
    fu = equalize.demod_frames(cfg, win, rot)
    assert kernels.launch_counts()["equalize"] == 1
    bins = sync._bins_on(dev, cfg.nfft, cfg.num_data_bins)
    f = torch.fft.fft(win, cfg.nfft, dim=-1)[..., bins]
    power = (f.abs() ** 2).sum(-1, keepdim=True)
    ref = f * torch.sqrt(f.shape[-1] / power) * rot[:, None, :]
    torch.testing.assert_close(fu, ref, atol=2e-4, rtol=0)
    a, ha = pilots.equalize_data_symbols_pilot(
        cfg, xs, ptr, delay, num_patterns, return_chan=True)
    b, hb = _moved(pilots.equalize_data_symbols_pilot(
        cfg, xs.cpu(), ptr.cpu(), delay.cpu(), num_patterns,
        return_chan=True), dev)
    torch.testing.assert_close(a, b, atol=2e-4, rtol=0)
    torch.testing.assert_close(ha, hb, atol=2e-5, rtol=0)


@pytest.mark.parametrize("cfg", [
    dataclasses.replace(G24, modulation="QAM16"),
    dataclasses.replace(G24, modulation="QAM64"),
    dataclasses.replace(G24, modulation="QAM16", pilot_grid="lte",
                        pilot_spacing=4, channel="Ideal"),
    dataclasses.replace(G24, modulation="QAM64", pilot_grid="random",
                        ref_sigs=0.3),
    dataclasses.replace(L8, modulation="QAM64", pilot_grid="lte",
                        pilot_spacing=6)],
    ids=["qam16", "qam64", "qam16-lte4-ideal", "qam64-random",
         "lte1024-qam64-lte6"])
def test_qam_and_pilot_chain_kernel_path_equals_plain(dev, cfg):
    """chain_batch at 100 dB for QAM and pilot configs: one launch of each
    kernel, every frame locked with BER 0, and the plain chain's bits."""
    n_samples = cfg.frame_len + cfg.nfft - 1
    n_trials, num_patterns = rxofdm.plan_rx(cfg, n_samples)
    bits, _ = _frames(cfg, dev, 4, seed=32)
    noise = _cplx(dev, 33, 4, n_samples)
    h = chain.loopback_taps(cfg)
    kernels.reset_launch_counts()
    r = chain.chain_batch(cfg, h, n_trials, num_patterns, bits, noise=noise)
    assert kernels.launch_counts() == {
        **dict.fromkeys(kernels.KERNEL_MODULES, 1), "tracker": 0,
        "mimo_detect": 0}
    assert bool(r.found.all()) and float(r.ber.max()) == 0.0
    p = _moved(chain.chain_batch(cfg, h, n_trials, num_patterns, bits.cpu(),
                                 noise=noise.cpu()), dev)
    assert torch.equal(r.hard_bits, p.hard_bits)
    assert torch.equal(r.lock_ptr, p.lock_ptr)
    one = rxofdm.rx_frame(cfg, _frames(cfg, dev, 2, seed=34)[1], n_trials,
                          num_patterns)
    assert one.hard_bits.shape == (2, cfg.num_bits) and bool(one.found.all())


def _legacy_stream(cfg, dev, n_frames, seed, cfo_hz=0.0):
    bits = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2, (n_frames, cfg.num_bits), dtype=np.int32)).to(dev)
    tx = txofdm.tx_frames(cfg, bits).reshape(1, -1)
    x = channel.apply_channel(tx, chain.loopback_taps(cfg))[0]
    t = torch.arange(len(x), device=dev, dtype=torch.float64)
    return (x * torch.exp(1j * (2 * np.pi * cfo_hz / cfg.fs) * t).to(
        torch.complex64)).contiguous()


# The legacy receivers' plain path on CPU copies runs their torch.fft search
# and spectra on the CPU as well; at the cases' 100 dB the MMSE gain is
# near 1 / H, which scales that rounding up at a deep-fade bin (a phasor of
# ~412 moved by 1.3e-2, 3e-5 of it): floats there are held to it relatively.
LEGACY_PLAIN_RTOL = 1e-4

LEGACY_CASES = pytest.mark.parametrize("table,case,cfo_hz", [
    (CFO_CASES, 0, 1500.0), (CFO_CASES, 7, 1500.0), (DSSS_CASES, 4, 0.0),
    (DSSS_CASES, 9, 0.0)], ids=["cfo0", "cfo7", "dsss4", "dsss9"])


@LEGACY_CASES
def test_rx_frame_cfo_kernel_path_equals_plain(dev, table, case, cfo_hz):
    """The whole-buffer legacy receiver as a user builds it (on the card,
    K2 by default): one K2 launch and no other kernel; the table equal to
    the plain path's (CPU copies), floats within 2e-4."""
    cfg = config_from_case(table, case)
    fo_range = (0.0, -1500.0, 1500.0) if cfo_hz else (0.0,)
    dsss = table[case]["dsss"]
    x = _legacy_stream(cfg, dev, 3, seed=35, cfo_hz=cfo_hz)
    make = lambda **kw: legacy_rx.make_legacy_rx(
        cfg, len(x), fo_range=fo_range, dsss=dsss, max_det=128, **kw)
    kernels.reset_launch_counts()
    r = make()(x)
    assert kernels.launch_counts() == {**dict.fromkeys(
        kernels.KERNEL_MODULES, 0), "equalize": 1}
    assert 3 * cfg.num_patterns // 2 <= int(r.count) < 128
    p = _moved(make(device="cpu")(x.cpu()), dev)
    for name in ("ptrs", "delays", "fo_idx", "count"):
        assert torch.equal(getattr(r, name), getattr(p, name)), name
    for name in ("phasors", "despread", "chan_freq"):
        torch.testing.assert_close(getattr(r, name), getattr(p, name),
                                   atol=2e-4, rtol=0)
    assert kernels.launch_counts()["equalize"] == 1


@LEGACY_CASES
def test_legacy_stream_kernel_path_equals_plain(dev, table, case, cfo_hz):
    """LegacyStreamingRx with no device: one K2 launch a step and no other
    kernel; every field of every chunk equal to the plain path's, floats
    within 2e-4; push_many == pushes; no step waits for the host."""
    cfg = config_from_case(table, case)
    fo_range = (0.0, -1500.0, 1500.0) if cfo_hz else (0.0,)
    dsss = table[case]["dsss"]
    chunk = 128 * cfg.stride
    x = _legacy_stream(cfg, dev, 12, seed=36, cfo_hz=cfo_hz)
    k = len(x) // chunk
    chunks = x[:k * chunk].reshape(k, chunk)
    make = lambda **kw: rt.LegacyStreamingRx(cfg, chunk, fo_range=fo_range,
                                             dsss=dsss, **kw)
    rx = make()
    assert rx.device.type == "cuda"
    kernels.reset_launch_counts()
    many = rx.push_many(chunks)
    tail = rx.finish()
    assert kernels.launch_counts() == {**dict.fromkeys(
        kernels.KERNEL_MODULES, 0), "equalize": k + len(tail)}
    assert int(many.valid.sum()) >= k * chunk // (
        cfg.pattern_len * cfg.rx_b_len) // 2
    plain = _moved(make(device="cpu").push_many(chunks.cpu()), dev)
    for name in many._fields:
        a, b = getattr(many, name), getattr(plain, name)
        if a.dtype.is_floating_point or a.dtype.is_complex:
            torch.testing.assert_close(a, b, atol=2e-4,
                                       rtol=LEGACY_PLAIN_RTOL)
        else:
            assert torch.equal(a, b), name
    seq = make()
    for i, c in enumerate(chunks):
        out = seq.push(c)
        for name in out._fields:
            assert torch.equal(getattr(out, name), getattr(many, name)[i])
    torch.cuda.set_sync_debug_mode("error")
    try:
        seq.push(chunks[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_split_rx_on_the_card_equals_rx_frame(dev):
    """make_split_rx with no device: K4 then K2, one launch each, and the
    monolithic rx_frame's lock, delay and bits."""
    cfg = GOLDEN64
    bits, xs = _frames(cfg, dev, 1, seed=37)
    find, demod = split.make_split_rx(cfg, xs.shape[1])
    kernels.reset_launch_counts()
    a = find(xs[0])
    b = demod(a.passthrough, a.ptrs[0], a.delays[0])
    counts = kernels.launch_counts()
    assert (counts["sync_search"], counts["equalize"]) == (1, 1)
    mono = rxofdm.make_rx(cfg, xs.shape[1])(xs[0])
    assert int(a.count) == cfg.num_patterns
    assert (int(a.ptrs[0]), int(a.delays[0])) == (int(mono.lock_ptr),
                                                  int(mono.delay_idx))
    assert torch.equal(b.hard_bits, mono.hard_bits)
    assert torch.equal(b.hard_bits, bits[0])


def test_qam_serving_kernel_path_equals_plain_path(dev):
    """The continuous receiver on QAM16 streams: kernel path == plain path
    in tables and hard bits, the unbiased phasors within 2e-4."""
    cfg = dataclasses.replace(GOLDEN64, modulation="QAM16")
    k, batch, chunk = 4, 3, 4800
    chunks = _streams(cfg, dev, batch, k * chunk, seed=38).reshape(
        batch, k, chunk).transpose(0, 1).contiguous()
    many = rt.BatchReacqStreamingRx(cfg, chunk, batch).push_many(chunks)
    plain = _moved(rt.BatchReacqStreamingRx(
        cfg, chunk, batch, device="cpu").push_many(chunks.cpu()), dev)
    assert many.hard_bits.shape[-1] == 4 * cfg.num_data_bins
    for name in ("ptrs", "delays", "valid", "demod_ok", "hard_bits"):
        assert torch.equal(getattr(many, name), getattr(plain, name)), name
    torch.testing.assert_close(many.phasors, plain.phasors, atol=2e-4, rtol=0)
    assert int(many.valid.sum()) >= batch * (k * chunk // 320 - 2)


def test_twins_run_without_tf32(dev):
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    _, xs = _frames(G24, dev, 1, seed=9)
    n_trials, _ = rxofdm.plan_rx(G24, xs.shape[1])
    sync_search.sync_corr_abs_plain(G24, xs, n_trials)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_wrappers_check_inputs(dev):
    with pytest.raises(ValueError):
        equalize.demod_windows(G24, _cplx(dev, 1, 4, 32), _cplx(dev, 2, 60))
    with pytest.raises(ValueError):
        channel_conv.apply_channel_frames(_cplx(dev, 1, 2, 100),
                                          np.ones(17, np.complex64), 64)


def test_library_builds_from_sources(dev):
    lib = _cuda.library()
    assert _cuda.library_path().exists()
    assert lib.cuda_error_string(0).decode() == "no error"


TRACKER_CFGS = pytest.mark.parametrize("cfg", [
    GOLDEN64, dataclasses.replace(G24, synch_dat=(2, 2)),
    dataclasses.replace(G24, nfft=128, cp_len=32, num_data_bins=120,
                        num_synch_bins=126)],
    ids=["golden64", "m_synch2", "nfft128"])


def _same_scan(cfg, xs, steps, max_det, kind, ref, carry=None):
    """The tracker kernel of route ``kind`` against a scan ``ref`` = (carry,
    ys) on the same inputs (from ``carry``, else the empty one): every
    carry field (float bits too), accept, pointer and delay at every step
    equal, peaks within 1e-5 of their size, the compacted channel table
    within 1e-5."""
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker
    n = xs.shape[1]
    if carry is None:
        carry = tracker.tracker_init_carry(len(xs), xs.device)
    before = dict(ktrk.route_launches)
    ck, yk = ktrk._launch(kind, cfg, xs, 0, n, carry, steps, max_det)
    assert ktrk.route_launches[kind] == before[kind] + 1
    cp_, yp = ref
    for name, a, b in zip(tracker.TrackerCarry._fields, ck, cp_):
        assert torch.equal(a, b), name
    for name, a, b in zip(("accept", "ptr", "delay"), yk, yp):
        assert torch.equal(a, b), name
    torch.testing.assert_close(yk[3], yp[3], rtol=1e-5, atol=0)
    assert yk[4].shape == (len(xs), max_det, cfg.nfft)
    torch.testing.assert_close(yk[4], yp[4], atol=1e-5, rtol=0)
    return ck, yk


@TRACKER_CFGS
def test_track_scan_kernel_equals_plain(dev, cfg):
    """The tracker's step-loop kernels against their plain twin on three
    streams, on both routes (the rule's and the other one): every carry
    field (float bits too), accept, pointer and delay at every step equal,
    peaks within 1e-5 of their size, the compacted channel table within
    1e-5, with max_det below the accept count too; track_frame on the card
    (one tracker and one K2 launch) == the plain path (CPU copies)."""
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker
    bits, xs = _frames(cfg, dev, 3, seed=40)
    xs = xs.contiguous()
    n = xs.shape[1]
    steps = int(np.ceil(n / tracker.tracker_stride(cfg))) + 1
    carry = tracker.tracker_init_carry(3, dev)
    assert ktrk.route(cfg) == "warp"
    kernels.reset_launch_counts()
    ck, yk = ktrk.track_scan(cfg, xs, 0, n, carry, steps, cfg.num_patterns)
    assert kernels.launch_counts()["tracker"] == 1
    assert ktrk.route_launches == {"warp": 1, "block": 0}
    c_ref, y_ref = ktrk.track_scan_plain(cfg, xs, 0, n, carry, steps,
                                         cfg.num_patterns)
    for max_det in (cfg.num_patterns, cfg.num_patterns // 3):
        # a shorter table is the first max_det rows of the longer one
        ref = c_ref, (*y_ref[:4], y_ref[4][:, :max_det])
        for kind in ("warp", "block"):
            _same_scan(cfg, xs, steps, max_det, kind, ref)
    kernels.reset_launch_counts()
    r = tracker.make_tracker(cfg, n)(xs)
    assert kernels.launch_counts() == {**dict.fromkeys(
        kernels.KERNEL_MODULES, 0), "tracker": 1, "equalize": 1}
    p = _moved(tracker.make_tracker(cfg, n, device="cpu")(xs.cpu()), dev)
    for name in ("count", "ptrs", "delays", "hard_bits"):
        assert torch.equal(getattr(r, name), getattr(p, name)), name
    torch.testing.assert_close(r.chan_freq, p.chan_freq, atol=1e-5, rtol=0)
    torch.testing.assert_close(r.phasors, p.phasors, atol=2e-4, rtol=0)
    assert bool((r.count == cfg.num_patterns).all())
    if cfg.m_synch == 1:
        assert torch.equal(r.hard_bits[:, :cfg.num_bits], bits)


NFFT256 = dataclasses.replace(G24, nfft=256, cp_len=64, num_data_bins=240,
                              num_synch_bins=254)


@pytest.mark.parametrize("cfg,n_sym", [
    (NFFT256, 24), (dataclasses.replace(NFFT256, synch_dat=(2, 2)), 24),
    (LTE1024, 16), (LTE2048, 16)],
    ids=["nfft256", "nfft256-m_synch2", "lte1024", "lte2048"])
def test_tracker_block_route(dev, cfg, n_sym):
    """Shapes the rule gives to the block route (nfft 256 with one and two
    synch symbols, short LTE1024 and LTE2048 buffers of 16 symbols): the
    kernel == the plain twin, every pattern block detected, with the sent
    bits where one synch symbol leads each block (with two the demod reads
    the second synch symbol first, as the reference does)."""
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker
    cfg = dataclasses.replace(cfg, num_ofdm_symb=n_sym)
    assert ktrk.route(cfg) == "block"
    bits, xs = _frames(cfg, dev, 2, seed=43)
    xs = xs.contiguous()
    n = xs.shape[1]
    steps = int(np.ceil(n / tracker.tracker_stride(cfg))) + 1
    ref = ktrk.track_scan_plain(cfg, xs, 0, n, tracker.tracker_init_carry(
        2, dev), steps, cfg.num_patterns)
    _same_scan(cfg, xs, steps, cfg.num_patterns, "block", ref)
    r = tracker.make_tracker(cfg, n)(xs)
    assert bool((r.count == cfg.num_patterns).all())
    if cfg.m_synch == 1:
        assert torch.equal(r.hard_bits[:, :cfg.num_bits], bits)


def test_tracker_block_route_frozen_steps(dev):
    """LTE1024 with three times the steps the buffer needs: the block route
    leaves its loop at the first step that does not fire, and the frozen
    steps' outputs (every one past the buffer's end) == the twin's."""
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker
    cfg = dataclasses.replace(LTE1024, num_ofdm_symb=16)
    _, xs = _frames(cfg, dev, 2, seed=45)
    xs = xs.contiguous()
    n = xs.shape[1]
    steps = 3 * (int(np.ceil(n / tracker.tracker_stride(cfg))) + 1)
    ref = ktrk.track_scan_plain(cfg, xs, 0, n, tracker.tracker_init_carry(
        2, dev), steps, cfg.num_patterns)
    assert int(ref[0].loop_count.max()) < steps // 3
    _same_scan(cfg, xs, steps, cfg.num_patterns, "block", ref)


def test_tracker_block_route_chained_calls(dev):
    """A stream's chunks: the carry of a first block-route call fed to a
    second == the twin's two calls, in every carry field's bits and every
    output of both calls."""
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker
    cfg = dataclasses.replace(LTE1024, num_ofdm_symb=32)
    _, xs = _frames(cfg, dev, 3, seed=46)
    xs = xs.contiguous()
    n = xs.shape[1]
    first = 3               # a detection a step once locked: 3, then 5
    rest = int(np.ceil(n / tracker.tracker_stride(cfg))) + 1 - first
    carry = tracker.tracker_init_carry(3, dev)
    ref1 = ktrk.track_scan_plain(cfg, xs, 0, n, carry, first, 8)
    ref2 = ktrk.track_scan_plain(cfg, xs, 0, n, ref1[0], rest, 8)
    assert bool((ref1[1][0].sum(1) >= 2).all())
    assert bool((ref2[1][0].sum(1) >= 4).all())   # the fit runs there
    ck, _ = _same_scan(cfg, xs, first, 8, "block", ref1, carry)
    _same_scan(cfg, xs, rest, 8, "block", ref2, ck)


def test_tracker_warp_route_equals_block_route(dev):
    """GOLDEN64 on 8 streams: the warp route == the block route in every
    integer output and every carry field's bits, peaks within 1e-5 of their
    size, channel tables within 1e-5; and with the carry of a first call
    passed to a second (a stream's chunks), the same again."""
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker
    cfg = GOLDEN64
    _, xs = _frames(cfg, dev, 8, seed=44)
    xs = xs.contiguous()
    n = xs.shape[1]
    carry = tracker.tracker_init_carry(8, dev)
    for steps in (30, 1800):
        w = ktrk._launch("warp", cfg, xs, 0, n, carry, steps, 40)
        b = ktrk._launch("block", cfg, xs, 0, n, carry, steps, 40)
        for name, x, y in zip(tracker.TrackerCarry._fields, w[0], b[0]):
            assert torch.equal(x, y), name
        for x, y in zip(w[1][:3], b[1][:3]):
            assert torch.equal(x, y)
        torch.testing.assert_close(w[1][3], b[1][3], rtol=1e-5, atol=0)
        torch.testing.assert_close(w[1][4], b[1][4], atol=1e-5, rtol=0)
        carry = w[0]


@pytest.mark.parametrize("cfg", [
    GOLDEN64, dataclasses.replace(LTE1024, num_data_bins=600,
                                  num_ofdm_symb=32)],
    ids=["golden64", "lte1024"])
def test_tracker_routes_at_a_2_28_base(dev, cfg):
    """Buffers whose first sample is global sample 2^28, from a carry whose
    search starts there: both routes' kernels == the plain twin in every
    carry field (b's bits too), accept, pointer and delay, the drift
    prediction included (every pattern block detected, on the block grid);
    and == the same buffers at base 0, every pointer 2^28 later."""
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker
    base = 2 ** 28
    _, xs = _frames(cfg, dev, 3, seed=47)
    xs = xs.contiguous()
    n = xs.shape[1]
    steps = int(np.ceil(n / tracker.tracker_stride(cfg))) + 1
    far = tracker.tracker_init_carry(3, dev)
    far = far._replace(loop_count=torch.full_like(
        far.loop_count, base // tracker.tracker_stride(cfg)))
    c_ref, y_ref = ktrk.track_scan_plain(cfg, xs, base, base + n, far, steps,
                                         cfg.num_patterns)
    assert bool((y_ref[0].sum(1) == cfg.num_patterns).all())
    assert int(c_ref.corr_obs.min()) >= 5            # the fit predicted
    _, y0 = ktrk.track_scan_plain(cfg, xs, 0, n, tracker.tracker_init_carry(
        3, dev), steps, cfg.num_patterns)
    assert torch.equal(y_ref[1], y0[1] + base)
    for kind in ("warp", "block") if cfg.nfft <= 128 else ("block",):
        ck, yk = ktrk._launch(kind, cfg, xs, base, base + n, far, steps,
                              cfg.num_patterns)
        for name, a, b in zip(tracker.TrackerCarry._fields, ck, c_ref):
            assert torch.equal(a, b), (kind, name)
        for name, a, b in zip(("accept", "ptr", "delay"), yk, y_ref):
            assert torch.equal(a, b), (kind, name)
        torch.testing.assert_close(yk[3], y_ref[3], rtol=1e-5, atol=0)
        torch.testing.assert_close(yk[4], y_ref[4], atol=1e-5, rtol=0)


def test_batch_tracker_stream_on_the_card(dev):
    """BatchTrackerStreamingRx on 4 LTE1024 streams (the block route): one
    tracker and one K2 launch a chunk step whatever B is, every stream ==
    a TrackerStreamingRx of its own bit for bit, the plain path's integers
    (one eager plain step), and a step under sync debug mode "error"."""
    cfg = dataclasses.replace(LTE1024, num_data_bins=600, num_ofdm_symb=32)
    _, xs = _frames(cfg, dev, 4, seed=48)
    x = xs[:, :cfg.frame_len].contiguous()
    chunk = 16384
    k = cfg.frame_len // chunk
    rx = rt.BatchTrackerStreamingRx(cfg, chunk, 4)
    kernels.reset_launch_counts()
    outs = [rx.push(x[:, i * chunk:(i + 1) * chunk]) for i in range(k)]
    assert kernels.launch_counts() == {**dict.fromkeys(
        kernels.KERNEL_MODULES, 0), "tracker": k, "equalize": k}
    found = sum(int(o.valid.sum()) for o in outs)
    assert found >= 4 * (cfg.num_patterns - 2)
    for b in (0, 3):
        one = rt.TrackerStreamingRx(cfg, chunk)
        for i, o in enumerate(outs):
            w = one.push(x[b, i * chunk:(i + 1) * chunk])
            for name in w._fields:
                assert torch.equal(getattr(o, name)[b], getattr(w, name)), \
                    name
    plain = rt.BatchTrackerStreamingRx(cfg, chunk, 4, device="cpu")
    for i, o in enumerate(outs[:2]):
        p = plain.push(x[:, i * chunk:(i + 1) * chunk].cpu())
        for name in ("ptrs", "delays", "valid", "hard_bits"):
            assert torch.equal(getattr(o, name).cpu(), getattr(p, name)), name
    torch.cuda.set_sync_debug_mode("error")
    try:
        rx.push(x[:, :chunk])
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_tracker_kernel_shape_rule(dev):
    """An nfft that is not a power of two, no synch symbol, or a carry of
    another type raises ValueError on a CUDA tensor."""
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker
    x = _cplx(dev, 41, 1, 4000)
    carry = tracker.tracker_init_carry(1, dev)
    for bad in (dataclasses.replace(G24, nfft=96, num_synch_bins=94,
                                    num_data_bins=90),
                dataclasses.replace(G24, synch_dat=(0, 3))):
        with pytest.raises(ValueError):
            ktrk.track_scan(bad, x, 0, 4000, carry, 8, 4)
    with pytest.raises(ValueError):
        ktrk.track_scan(G24, x, 0, 4000, carry._replace(
            b=carry.b.double()), 8, 4)


def test_tracker_stream_on_the_card(dev):
    """TrackerStreamingRx with no device: one tracker and one K2 launch a
    chunk step, chunked == track_frame on the whole buffer, push_many ==
    pushes, a step under sync debug mode "error"."""
    from lte_gnu_radio_code_tpu_torch.models import tracker
    cfg = GOLDEN64
    bits, xs = _frames(cfg, dev, 2, seed=42)
    x = xs[:, :cfg.frame_len].reshape(-1)
    chunk = 2400
    k = len(x) // chunk
    rx = rt.TrackerStreamingRx(cfg, chunk)
    assert rx.device.type == "cuda"
    kernels.reset_launch_counts()
    many = rx.push_many(x[:k * chunk].reshape(k, chunk))
    tail = rx.finish()
    steps = k + len(tail)
    assert kernels.launch_counts() == {**dict.fromkeys(
        kernels.KERNEL_MODULES, 0), "tracker": steps, "equalize": steps}
    outs = [type(many)(*(f[i] for f in many)) for i in range(k)] + tail
    v = torch.cat([o.valid for o in outs])
    ptrs = torch.cat([o.ptrs for o in outs])[v]
    hard = torch.cat([o.hard_bits for o in outs])[v].reshape(-1)
    n = k * chunk
    whole = tracker.make_tracker(cfg, n, max_det=n // 320 + 2)(x[:n])
    nb = int(whole.count)
    assert len(ptrs) == nb >= 2 * cfg.num_patterns - 2
    assert torch.equal(ptrs, whole.ptrs[:nb])
    assert torch.equal(hard, whole.hard_bits[:len(hard)])
    assert torch.equal(hard[:cfg.num_bits], bits[0])
    seq = rt.TrackerStreamingRx(cfg, chunk)
    for i, c in enumerate(x[:k * chunk].reshape(k, chunk)):
        out = seq.push(c)
        for name in out._fields:
            assert torch.equal(getattr(out, name), getattr(many, name)[i])
    torch.cuda.set_sync_debug_mode("error")
    try:
        seq.push(x[:chunk])
    finally:
        torch.cuda.set_sync_debug_mode("default")


# -- 2x2 MIMO, PLS and the native ring on the card ------------------------------

MIMO_CFG_LIST = [
    dataclasses.replace(GOLDEN64, synch_dat=(2, 2), num_ofdm_symb=48,
                        num_ant_txrx=2),
    dataclasses.replace(config_from_profile(SDR_PROFILES[1]),
                        synch_dat=(2, 2), snr_db=100.0)]
MIMO_CFGS = pytest.mark.parametrize("cfg", MIMO_CFG_LIST,
                                    ids=["test-cfg", "wifimimosm-a"])


@MIMO_CFGS
@pytest.mark.parametrize("kind", ["direct", "fft"])
def test_k4_at_zc_slice_zero(dev, cfg, kind):
    """K4 at the MIMO search's shape (the single-synch view, ZC slice 0 of
    the two-symbol sequence) on both routes, forced, against the twin and
    the FFT-form plain version at the same slice; the slice's result is
    not the one at the single-synch config's own sequence."""
    cfg1 = mimo.search_config(cfg)
    zc0 = mimo._search_zc(cfg)
    n = cfg.frame_len + cfg.nfft - 1
    x = _cplx(dev, 50, 5, n)
    n_trials = sync.n_trials_for(cfg1, n)
    out = sync_search._launch(kind, cfg1, x, n_trials, zc=zc0)
    torch.testing.assert_close(
        out, sync_search.sync_corr_abs_plain(cfg1, x, n_trials, zc=zc0),
        **K4_TOL)
    torch.testing.assert_close(
        out, sync_search.sync_corr_abs_fft_plain(cfg1, x, n_trials, zc=zc0),
        **K4_TOL)
    own = sync_search._launch(kind, cfg1, x, n_trials)
    assert float((own - out).abs().max()) > 0.1
    assert sync_search.route(cfg1.nfft, cfg1.cp_len, cfg1.stride,
                             cfg1.m_synch) == "direct"


@MIMO_CFGS
@pytest.mark.parametrize("mode", ["spmult", "stcode"])
def test_mimo_kernel_path_equals_plain_path(dev, cfg, mode):
    """Both chains on the card, K4 against its twin on one noise tensor at
    the config's SNR and at 12 dB: lock, delay and bits equal; one K4
    launch a step, on the direct route; at 100 dB every frame locked with
    BER 0; a step under torch's sync debug mode "error"."""
    make = mimo.make_mimo_chain if mode == "spmult" else \
        mimo.make_stcode_chain
    n = cfg.frame_len + cfg.nfft - 1
    shape = (16, 2) if mode == "spmult" else (16,)
    bits = torch.from_numpy(np.random.default_rng(51).integers(
        0, 2, (*shape, cfg.num_bits), dtype=np.int32)).to(dev)
    for snr in (100.0, 12.0):
        c = dataclasses.replace(cfg, snr_db=snr)
        noise = _cplx(dev, 52, 16, 2, n)
        kernels.reset_launch_counts()
        before = dict(sync_search.route_launches)
        rk = make(c)(bits, noise=noise)
        assert kernels.launch_counts()["sync_search"] == 1
        assert mimo_detect.launches == 2 * (mode == "spmult")
        assert sync_search.route_launches == {
            **before, "direct": before["direct"] + 1}
        rp = _moved(make(c, device="cpu")(bits.cpu(), noise=noise.cpu()),
                    dev)
        assert kernels.launch_counts()["sync_search"] == 1
        for f in ("found", "lock_ptr", "delay_idx", "hard_bits"):
            assert torch.equal(getattr(rk, f), getattr(rp, f)), (snr, f)
        if snr == 100.0:
            assert bool(rk.found.all()) and float(rk.ber.max()) == 0.0
            assert bool((rk.lock_ptr == cfg.cp_len).all())
    step = make(cfg)
    gen = torch.Generator(device=dev).manual_seed(53)
    step(bits, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(bits, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")


L2K_2X2 = dataclasses.replace(LTE2048, synch_dat=(2, 6), num_ant_txrx=2)


def test_mimo_lte20_step_kernel_path_equals_plain_path(dev):
    """The 2x2 SpMult step at 20 MHz LTE widths (``l2k-2x2-link``'s
    configuration: nfft 2048, synch_dat (2, 6), 64 symbols), 4 frames at
    100, 24 and 6 dB on one noise tensor against the plain path: found, lock
    and delay equal, hard bits equal where the plain path's rail lies
    farther than 1e-4 from a boundary, phasors within 1e-4 and the channel
    estimate within 4e-5 (the cell's limits against float64; the two
    paths' float32 FFTs differ by less); one K4 launch a step, on the FFT
    route in the peaks form; at 100 dB every frame locked at the first
    trial with BER 0; a step under torch's sync debug mode "error"."""
    n = L2K_2X2.frame_len + L2K_2X2.nfft - 1
    bits = torch.from_numpy(np.random.default_rng(56).integers(
        0, 2, (4, 2, L2K_2X2.num_bits), dtype=np.int32)).to(dev)
    noise = _cplx(dev, 57, 4, 2, n)
    for snr in (100.0, 24.0, 6.0):
        cfg = dataclasses.replace(L2K_2X2, snr_db=snr)
        kernels.reset_launch_counts()
        before = (dict(sync_search.route_launches),
                  dict(sync_search.peak_launches))
        rk = mimo.make_mimo_chain(cfg)(bits, noise=noise)
        assert kernels.launch_counts()["sync_search"] == 1
        assert mimo_detect.launches == 2
        assert sync_search.route_launches == {
            **before[0], "fft": before[0]["fft"] + 1}
        assert sync_search.peak_launches == {
            **before[1], "fft": before[1]["fft"] + 1}
        rp = _moved(mimo.make_mimo_chain(cfg, device="cpu")(
            bits.cpu(), noise=noise.cpu()), dev)
        for f in ("found", "lock_ptr", "delay_idx"):
            assert torch.equal(getattr(rk, f), getattr(rp, f)), (snr, f)
        assert float((rk.phasors - rp.phasors).abs().max()) <= 1e-4
        assert float((rk.chan_freq - rp.chan_freq).abs().max()) <= 4e-5
        differ = (rk.hard_bits != rp.hard_bits).cpu().numpy()
        margin = rail_margin(rp.phasors.cpu().numpy()).reshape(differ.shape)
        assert not (differ & (margin > 1e-4)).any()
        if snr == 100.0:
            assert bool(rk.found.all()) and float(rk.ber.max()) == 0.0
            assert bool((rk.lock_ptr == L2K_2X2.cp_len).all())
    step = mimo.make_mimo_chain(L2K_2X2)
    step(bits, noise=noise)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(bits, noise=noise)
    finally:
        torch.cuda.set_sync_debug_mode("default")


DETECT_CELLS = pytest.mark.parametrize("cfg,frames", [
    (MIMO_CFG_LIST[0], 16), (dataclasses.replace(MIMO_CFG_LIST[1],
                                                 snr_db=50.0), 16),
    (dataclasses.replace(L2K_2X2, snr_db=12.0), 8)],
    ids=["test-cfg", "wifimimosm-a", "lte2048_2x2"])


def _detect_inputs(cfg, frames, dev, seed):
    """What ``rx_frame_mimo`` hands the detection: the data bins and the
    2x2 estimate of seeded frames through the 2x2 Fading channel and AWGN
    at cfg's SNR, and the data bins' index table; every frame locked."""
    n = cfg.frame_len + cfg.nfft - 1
    n_trials, num_patterns = mimo.plan(cfg, n)
    bits = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2, (frames, 2, cfg.num_bits), dtype=np.int32)).to(dev)
    sig = mimo.tx_frame_mimo(cfg, bits)
    clean = channel.apply_channel_mimo(sig, torch.as_tensor(
        channel.mimo2_taps("Fading"), device=dev), max_impulse=cfg.nfft)
    y = channel.awgn(cfg, clean, (sig.abs() ** 2).mean((-2, -1))[
        ..., None, None], noise=_cplx(dev, seed + 1, frames, 2, n))
    _, _, found, chan, fd = mimo._front(cfg, y, n_trials, num_patterns)
    assert bool(found.all())
    return fd, chan, sync._bins_on(dev, cfg.nfft, cfg.num_data_bins)


@DETECT_CELLS
def test_mimo_detect_kernel_equals_twin(dev, cfg, frames):
    """The detection's kernel pair (``kernels/mimo_detect.py``) at the
    three MIMO shapes, on what the chain hands it, with lead dims [frames],
    [] and [0]: within 1e-5 of the twin (on CPU copies), the same QPSK
    decisions where the twin's rail lies farther than 1e-4 from a
    boundary, contiguous, two launches a call (none on zero frames), and
    a rerun bit-identical; y off 16 bytes and an odd B within 1e-5 of the
    twin too."""
    fd, chan, bins = _detect_inputs(cfg, frames, dev, seed=61)
    inv_snr = 1.0 / cfg.snr_linear

    def held(fd, chan, bins, launched):
        mimo_detect.launches = 0
        got = mimo_detect.detect(fd, chan, bins, inv_snr)
        assert mimo_detect.launches == launched
        want = mimo_detect.detect_plain(fd.cpu(), chan.cpu(), bins.cpu(),
                                        inv_snr)
        assert got.shape == want.shape and got.is_contiguous()
        if not got.numel():
            return got
        assert float((got.cpu() - want).abs().max()) <= 1e-5
        differ = (mimo._hard(cfg, got).cpu() != mimo._hard(cfg, want))
        margin = rail_margin(want.numpy()).reshape(differ.shape)
        assert not (differ.numpy() & (margin > 1e-4)).any()
        return got

    got = held(fd, chan, bins, 2)
    assert torch.equal(got, mimo_detect.detect(fd, chan, bins, inv_snr))
    held(fd[0], chan[0], bins, 2)
    held(fd[:0], chan[:0], bins, 0)
    off = torch.empty(fd.numel() + 1, dtype=fd.dtype, device=dev)[1:]
    off = off.view(fd.shape).copy_(fd)
    assert off.data_ptr() % 16 == 8
    held(off, chan, bins, 2)
    held(fd[..., :-1].contiguous(), chan, bins[:-1].contiguous(), 2)


def test_pls_exchange_on_the_card(dev):
    """A batch of synced key exchanges on the card, the delayed flat
    channel past the cp: zero errors, both locks at the delay; the same
    unitaries give the same bits as on the CPU."""
    from lte_gnu_radio_code_tpu_torch.models import pls as mpls
    from lte_gnu_radio_code_tpu_torch.ops import pls as opls
    from lte_gnu_radio_code_tpu_torch.utils.params import PLSConfig

    cfg = PLSConfig()
    keys = torch.from_numpy(np.random.default_rng(54).integers(
        0, 2, (32, 8), dtype=np.int32)).to(dev)
    h = np.zeros((2, 2, 41), complex)
    h[:, :, 40] = [[1.0 + 0.2j, 0.45j], [0.3 - 0.1j, 0.9 + 0.3j]]
    gen = torch.Generator(device=dev).manual_seed(55)
    bits, err, (pb, pa) = mpls.key_exchange_synced(cfg, keys, gen, h,
                                                   max_delay=64)
    assert bits.device.type == "cuda" and int(err.sum()) == 0
    assert bool((pb == 40).all()) and bool((pa == 40).all())
    u = opls.random_unitary(gen, (32, cfg.num_data_symb, cfg.num_subbands),
                            2)
    on_card = mpls.key_exchange_synced(cfg, keys, None, h, max_delay=64,
                                       unitaries=u)
    on_cpu = mpls.key_exchange_synced(cfg, keys.cpu(), None, h,
                                      max_delay=64, unitaries=u.cpu(),
                                      device="cpu")
    assert torch.equal(on_card[0].cpu(), on_cpu[0])


def test_native_chunks_feed_the_card_receiver(dev):
    """Chunks pumped from the native ring (CPU tensors) into the serving
    receiver on the card give the outputs of the same chunks pushed from
    the card."""
    from lte_gnu_radio_code_tpu_torch.runtime import native

    cfg, chunk, k = GOLDEN64, 4800, 4
    x = _streams(cfg, dev, 1, k * chunk, seed=56)[0]
    host = x.cpu()
    ring = native.NativeRing(1 << 15)
    chunker = native.NativeChunker(ring, chunk)
    rx = rt.ReacqStreamingRx(cfg, chunk)
    outs, pos = [], 0
    while pos < len(host):
        pos += ring.write(host[pos:pos + 4095])
        while (c := chunker.pump()) is not None:
            outs.append(rx.push(c))
    ref = rt.ReacqStreamingRx(cfg, chunk)
    direct = [ref.push(c) for c in x.reshape(k, chunk)]
    assert len(outs) == k
    for a, b in zip(outs, direct):
        for f, g in zip(a, b):
            assert torch.equal(f, g)


def _same_fields(a, b, atol=2e-4, skip=(), rtol=0.0):
    """Integer and bool fields equal, float fields within atol + rtol of
    their size."""
    for name in a._fields:
        if name in skip:
            continue
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype.is_floating_point or x.dtype.is_complex:
            torch.testing.assert_close(x, y, atol=atol, rtol=rtol)
        else:
            assert torch.equal(x, y), name


@pytest.mark.parametrize("cfg,n_shards", [(GOLDEN64, 4), (L8, 2)],
                         ids=["golden64-t4", "lte1024-t2"])
def test_sharded_rx_kernel_path_equals_plain_and_single(dev, cfg, n_shards):
    """The time-sharded RX on the card: one K4 and one K2 launch a call,
    found, lock, delay and bits equal to the plain path's (CPU copies) and
    to the single-device rx_frame on the kernels."""
    from lte_gnu_radio_code_tpu_torch.parallel import mesh, sharded

    if cfg.frame_len // n_shards < sharded.halo_size(cfg):
        cfg = dataclasses.replace(cfg, num_ofdm_symb=4 * cfg.num_ofdm_symb)
    bits, xs = _frames(cfg, dev, 2, seed=57)
    m = mesh.time_mesh(n_shards)
    n = xs.shape[1]
    kernels.reset_launch_counts()
    r = sharded.make_sharded_rx(cfg, n, m)(xs)
    assert kernels.launch_counts() == {**dict.fromkeys(
        kernels.KERNEL_MODULES, 0), "sync_search": 1, "equalize": 1}
    p = _moved(sharded.make_sharded_rx(
        cfg, n, mesh.time_mesh(n_shards, device="cpu"))(xs.cpu()), dev)
    one = rxofdm.make_rx(cfg, n)(xs)
    assert bool(r.found.all())
    for ref in (p, one):
        for name in ("found", "lock_ptr", "delay_idx", "hard_bits"):
            assert torch.equal(getattr(r, name), getattr(ref, name)), name
        torch.testing.assert_close(r.phasors, ref.phasors, atol=2e-4, rtol=0)
    assert torch.equal(r.hard_bits[:, :cfg.num_bits], bits)


def test_sharded_chain_equals_chain_batch_on_the_card(dev):
    """The dp x t chain on one noise tensor: BER, found and lock equal to
    chain_batch's, one launch of each of K1-K4 a step."""
    from lte_gnu_radio_code_tpu_torch.parallel import chain as pchain
    from lte_gnu_radio_code_tpu_torch.parallel import mesh

    cfg, b = GOLDEN64, 8
    n = cfg.frame_len + cfg.nfft - 1
    bits = torch.from_numpy(np.random.default_rng(58).integers(
        0, 2, (b, cfg.num_bits), dtype=np.int32)).to(dev)
    noise = _cplx(dev, 59, b, n)
    kernels.reset_launch_counts()
    ber, found, lock = pchain.make_sharded_chain(
        cfg, mesh.make_mesh(4, dp=2))(bits, noise=noise)
    assert kernels.launch_counts() == {**dict.fromkeys(
        kernels.KERNEL_MODULES, 1), "tracker": 0, "mimo_detect": 0}
    n_trials, num_patterns = rxofdm.plan_rx(cfg, n)
    ref = chain.chain_batch(cfg, chain.loopback_taps(cfg), n_trials,
                            num_patterns, bits, noise=noise)
    assert bool(found.all()) and float(ber.max()) == 0.0
    assert torch.equal(ber, ref.ber) and torch.equal(lock, ref.lock_ptr)


@pytest.mark.parametrize("kind", ["reacq", "legacy"])
def test_sharded_stream_kernel_path_equals_plain(dev, kind):
    """A sharded chunk step on the card: one K4 (reacq) and one K2 launch a
    step, every field equal to the plain path's and to the unsharded
    receiver's (floats within 2e-4), push_many == pushes, and no step
    waits for the host."""
    from lte_gnu_radio_code_tpu_torch.parallel import mesh, streaming

    n_shards = 4
    m = mesh.time_mesh(n_shards)
    if kind == "reacq":
        cfg, chunk = GOLDEN64, 4800
        x = _streams(cfg, dev, 1, 6 * chunk, seed=60)[0]
        make = lambda mesh_=m: streaming.ShardedReacqStreamingRx(cfg, chunk,
                                                                 mesh_)
        alone = rt.ReacqStreamingRx(cfg, chunk)
        want = {"sync_search": 1, "equalize": 1}
    else:
        cfg = config_from_case(CFO_CASES, 7)
        chunk = n_shards * 64 * cfg.stride
        x = _legacy_stream(cfg, dev, 6, seed=61, cfo_hz=1500.0)
        fo = (0.0, -1500.0, 1500.0)
        make = lambda mesh_=m: streaming.ShardedLegacyStreamingRx(
            cfg, chunk, mesh_, fo_range=fo)
        alone = rt.LegacyStreamingRx(cfg, chunk, fo_range=fo)
        want = {"equalize": 1}
    k = len(x) // chunk
    chunks = x[:k * chunk].reshape(k, chunk)
    rx = make()
    assert rx.device.type == "cuda"
    kernels.reset_launch_counts()
    many = rx.push_many(chunks)
    assert kernels.launch_counts() == {**dict.fromkeys(
        kernels.KERNEL_MODULES, 0), **{n: k * v for n, v in want.items()}}
    assert int(many.valid.sum()) > 0
    plain = make(mesh.time_mesh(n_shards, device="cpu"))
    _same_fields(many, _moved(plain.push_many(chunks.cpu()), dev),
                 skip=("peaks",),
                 rtol=LEGACY_PLAIN_RTOL if kind == "legacy" else 0.0)
    _same_fields(many, alone.push_many(chunks))
    seq = make()
    for i, c in enumerate(chunks):
        out = seq.push(c)
        for name in out._fields:
            assert torch.equal(getattr(out, name), getattr(many, name)[i])
    torch.cuda.set_sync_debug_mode("error")
    try:
        seq.push(chunks[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("backend", ["gloo", "nccl"],
                         ids=["one-card-gloo", "a-card-each-nccl"])
def test_t_across_processes_on_the_card(dev, tmp_path, backend):
    """"t" = 4 over 2 processes (2 shards each): the sharded RX, the reacq
    stream and the CFO case 7 legacy stream (+1500 Hz).  Over gloo both
    processes drive this card; over NCCL each its own (skipped unless 2
    cards are visible: NCCL refuses two ranks on one card), with one more
    chunk step under sync debug mode "error".  Every rank: one K4 (on the
    rule's route) and one K2 launch a call or step, outputs == the stacked
    run on this card (integers exact, floats within 2e-4)."""
    from test_torch_cards import RUNNERS, spawn

    from lte_gnu_radio_code_tpu_torch.parallel import mesh

    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip("one NCCL process a card needs 2 cards; "
                    f"{torch.cuda.device_count()} visible")
    nccl = backend == "nccl"
    lcfg = config_from_case(CFO_CASES, 7)
    common = dict(t=4, t_procs=2)
    jobs = {
        "rx": dict(kind="rx", cfg=dataclasses.asdict(GOLDEN64),
                   x=_frames(GOLDEN64, dev, 1, seed=62)[1][0].cpu(), **common),
        "reacq": dict(kind="reacq", chunk=4800,
                      cfg=dataclasses.asdict(GOLDEN64), no_sync=nccl,
                      x=_streams(GOLDEN64, dev, 1, 6 * 4800, 63)[0].cpu(),
                      **common),
        "legacy": dict(kind="legacy", chunk=4 * 64 * lcfg.stride,
                       cfg=dataclasses.asdict(lcfg), no_sync=nccl,
                       fo_range=(0.0, -1500.0, 1500.0),
                       dsss=CFO_CASES[7]["dsss"],
                       x=_legacy_stream(lcfg, dev, 6, 64, 1500.0).cpu(),
                       **common),
    }
    ranks = spawn(jobs, 2, tmp_path, device="cuda:0" if not nccl else "card",
                  backend=backend)
    for name, job in jobs.items():
        ref = RUNNERS[job["kind"]](job, mesh.time_mesh(4))
        steps = 1 if name == "rx" else ref["valid"].shape[0] + nccl
        cfg = GOLDEN64 if name != "legacy" else lcfg
        want = sync_search.route(cfg.nfft, cfg.cp_len, cfg.stride,
                                 cfg.m_synch)
        for rank, r in enumerate(ranks):
            got = r[name]
            assert got["launches"] == {
                **dict.fromkeys(kernels.KERNEL_MODULES, 0), "equalize": steps,
                "sync_search": 0 if name == "legacy" else steps}, (rank, name)
            if name != "legacy":
                assert got["routes"][want] == steps, (rank, name)
            for k, v in ref.items():
                x, y = got[k], v.cpu()
                if x.dtype.is_floating_point or x.dtype.is_complex:
                    torch.testing.assert_close(x, y, atol=2e-4, rtol=0)
                else:
                    assert torch.equal(x, y), (rank, name, k)
        assert bool(ranks[0][name]["found" if name == "rx" else "valid"].any())
