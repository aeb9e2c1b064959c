"""K4's two routes on the CPU: the premise of the FFT route (K_d is a
circular shift of K_0), the FFT-form plain version against the conv-bank
twin, a float64 numpy evaluation and the JAX package, the locks it gives,
the route rule, and the wrapper's CUDA branch with the launch recorded.
The kernels themselves are held to both plain versions on a CUDA device by
tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lte_gnu_radio_code_tpu.ops import fast_sync as jfs
from lte_gnu_radio_code_tpu.ops import sync as jsync
from lte_gnu_radio_code_tpu.pallas_kernels import sync_search as jsearch
from lte_gnu_radio_code_tpu.utils.params import GOLDEN64, LTE1024
from lte_gnu_radio_code_tpu_torch import kernels
from lte_gnu_radio_code_tpu_torch.kernels import _cuda, sync_search
from lte_gnu_radio_code_tpu_torch.ops import fast_sync, sync
from lte_gnu_radio_code_tpu_torch.ops.zadoff_chu import zc_for_config
from lte_gnu_radio_code_tpu_torch.utils import params as tparams
from lte_gnu_radio_code_tpu_torch.utils.params import used_bins
from torch_parity import port_cfg, reduced, rx_buffer

G24 = reduced(GOLDEN64, num_ofdm_symb=24)
L8 = reduced(LTE1024, num_ofdm_symb=8)
M2 = reduced(GOLDEN64, num_ofdm_symb=24, synch_dat=(2, 2))   # m_synch = 2
S15 = reduced(GOLDEN64, num_ofdm_symb=24, stride=15)         # odd starts
CASES = pytest.mark.parametrize("cfg", [G24, L8, M2, S15],
                                ids=["golden64", "lte1024", "m_synch2",
                                     "stride15"])


def _noise(cfg, frames, seed, extra=0):
    rng = np.random.default_rng(seed)
    n = cfg.frame_len + cfg.nfft - 1 + extra
    return (rng.standard_normal((frames, n)) +
            1j * rng.standard_normal((frames, n))).astype(np.complex64)


def _numpy_fft_form(cfg, x, n_trials):
    """The FFT form in float64 numpy, trial by trial, zeros past the end."""
    nfft, cp, m0, L = cfg.nfft, cfg.cp_len, cfg.m_synch, cfg.num_synch_bins
    bins = np.asarray(used_bins(nfft, L)[1])
    zc = zc_for_config(cfg).astype(np.complex128).reshape(m0, L)
    need = cp + (n_trials - 1) * cfg.stride + m0 * cfg.rx_b_len
    x = np.concatenate([x.astype(np.complex128), np.zeros(max(0, need))])
    out = np.zeros((n_trials, cp + 1))
    for p in range(n_trials):
        y, power = np.zeros(nfft, np.complex128), 0.0
        for l in range(m0):
            s0 = cp + p * cfg.stride + l * cfg.rx_b_len
            f = np.fft.fft(x[s0:s0 + nfft])[bins]
            power += (np.abs(f) ** 2).sum()
            y[bins] += f * np.conj(zc[l])
        corr = nfft * np.fft.ifft(y)[:cp + 1]
        out[p] = np.abs(corr) * np.sqrt(m0 * L / max(power, 1e-30))
    return out


@pytest.mark.parametrize("cfg", [GOLDEN64, L8, M2],
                         ids=["golden64", "lte1024", "m_synch2"])
def test_kernels_are_circular_shifts_of_k0(cfg):
    """The premise of the FFT route: inside each synch window,
    K_d[l (N+cp) + n] == K_0[l (N+cp) + (n - d) mod N]."""
    k = fast_sync._kernels(port_cfg(cfg))
    n = np.arange(cfg.nfft)
    tol = 1e-5 * np.abs(k).max()
    for l in range(cfg.m_synch):
        w = k[:, l * cfg.rx_b_len: l * cfg.rx_b_len + cfg.nfft]
        for d in range(cfg.cp_len + 1):
            assert np.abs(w[d] - w[0][(n - d) % cfg.nfft]).max() <= tol, (l, d)
    # and it is zero between the windows
    for l in range(cfg.m_synch - 1):
        gap = k[:, l * cfg.rx_b_len + cfg.nfft:(l + 1) * cfg.rx_b_len]
        assert not gap.any()


def test_zc_by_bin_table():
    for cfg in (port_cfg(G24), port_cfg(M2)):
        t = fast_sync._zc_by_bin(cfg)
        assert t.dtype == np.complex64 and t.shape == (cfg.m_synch, cfg.nfft)
        bins = np.asarray(used_bins(cfg.nfft, cfg.num_synch_bins)[1])
        np.testing.assert_array_equal(
            t[:, bins], np.conj(zc_for_config(cfg)).reshape(cfg.m_synch, -1))
        off = np.setdiff1d(np.arange(cfg.nfft), bins)
        assert not t[:, off].any() and (t[:, bins] != 0).all()


@CASES
def test_fft_form_matches_twin_and_float64(cfg):
    """Against the conv-bank twin at atol 3e-3 + rtol 2e-4 (the same sum
    in two orders in float32: over taps there, over FFT stages and bins
    here), and within 1e-4 of a float64 evaluation."""
    pcfg = port_cfg(cfg)
    x = _noise(cfg, 2, seed=1)
    n_trials = sync.n_trials_for(pcfg, x.shape[1])
    out = fast_sync.sync_corr_abs_fft(pcfg, torch.from_numpy(x), n_trials)
    assert out.dtype == torch.float32
    assert out.shape == (2, n_trials, cfg.cp_len + 1)
    twin = fast_sync.sync_corr_abs_fast(pcfg, torch.from_numpy(x), n_trials)
    np.testing.assert_allclose(out.numpy(), twin.numpy(), atol=3e-3,
                               rtol=2e-4)
    k = min(n_trials, 40)
    ref = np.stack([_numpy_fft_form(pcfg, x[i], k) for i in range(2)])
    np.testing.assert_allclose(out[:, :k].numpy(), ref, atol=1e-4, rtol=0)
    f64 = fast_sync.sync_corr_abs_fft(
        pcfg, torch.from_numpy(x.astype(np.complex128)), k)
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(f64.numpy(), ref, atol=1e-9, rtol=0)


def test_fft_form_matches_jax_kernel_golden64():
    x, _ = rx_buffer(G24, seed=2)
    n_trials = jsync.n_trials_for(G24, len(x))
    ref = np.asarray(jsearch.sync_corr_abs(G24, jnp.asarray(x), n_trials,
                                           interpret=True))
    out = fast_sync.sync_corr_abs_fft(port_cfg(G24), torch.from_numpy(x),
                                      n_trials)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-3)


@pytest.mark.parametrize("ref_form", ["spectra-ifft", "conv-bank"])
def test_fft_form_matches_jax_lte1024(ref_form):
    x = rx_buffer(L8, seed=5, snr_db=10.0)[0]
    n_trials = jsync.n_trials_for(L8, len(x))
    if ref_form == "spectra-ifft":
        ref = jsync.corr_abs_from_spectra(
            L8, jsync.sync_spectra(L8, jnp.asarray(x), n_trials), "ifft")
    else:
        ref = jfs.sync_corr_abs_fast(L8, jnp.asarray(x)[None], n_trials)[0]
    out = fast_sync.sync_corr_abs_fft(port_cfg(L8), torch.from_numpy(x),
                                      n_trials)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-3,
                               rtol=2e-4)


@pytest.mark.parametrize("cfg,snr_db", [(G24, None), (G24, 5.0), (L8, 10.0)],
                         ids=["golden64", "golden64-5dB", "lte1024-10dB"])
def test_first_lock_on_fft_form_equals_jax(cfg, snr_db):
    """Lock pointer, delay and found flag from the FFT-form |corr| equal
    the JAX package's on the same buffers (signal, and a noise-only one)."""
    pcfg = port_cfg(cfg)
    bufs = [rx_buffer(cfg, seed=s, snr_db=snr_db)[0] for s in (7, 8)]
    bufs.append(0.05 * _noise(cfg, 1, seed=9)[0])
    for x in bufs:
        n_trials = jsync.n_trials_for(cfg, len(x))
        jcorr = jfs.sync_corr_abs_fast(cfg, jnp.asarray(x)[None],
                                       n_trials)[0]
        jptr, jdelay, _, jfound, _ = jsync.first_lock(cfg, jcorr)
        corr = fast_sync.sync_corr_abs_fft(pcfg, torch.from_numpy(x),
                                           n_trials)
        ptr, delay, _, found, _ = sync.lock_from_peaks(pcfg, *corr.max(-1))
        assert bool(found) == bool(jfound)
        if bool(found):
            assert (int(ptr), int(delay)) == (int(jptr), int(jdelay))
    assert not bool(found)             # the last buffer is noise only


@pytest.mark.parametrize("nfft,cp,stride,m_synch,want", [
    (64, 16, 1, 1, "direct"),          # GOLDEN64
    (1024, 256, 255, 1, "fft"),        # LTE1024
    (2048, 512, 511, 1, "fft"),        # LTE2048
    (4096, 1024, 1023, 1, "fft"),
    (96, 24, 23, 1, "direct"),         # not a power of two
    (1536, 384, 383, 1, "direct"),
    (8192, 2048, 2047, 1, "direct"),   # past the FFT kernels' sizes
    (64, 16, 15, 1, "direct"),         # small: the product is cheap enough
    (64, 16, 1, 2, "direct"),
    (1024, 256, 255, 2, "fft"),        # m_synch = 2
    (1024, 256, 1, 1, "fft"),          # dense at LTE scale
    (16, 16, 15, 1, "direct"),         # cp + 1 > nfft
])
def test_route_rule(nfft, cp, stride, m_synch, want):
    assert sync_search.route(nfft, cp, stride, m_synch) == want
    if want == "fft":
        assert (sync_search.direct_ops(nfft, cp, m_synch) >=
                sync_search.FFT_ADVANTAGE * sync_search.fft_ops(nfft, m_synch))


def test_shipped_configs_take_their_routes():
    for cfg, want in ((tparams.GOLDEN64, "direct"), (tparams.LTE1024, "fft"),
                      (tparams.LTE2048, "fft")):
        assert sync_search.route(cfg.nfft, cfg.cp_len, cfg.stride,
                                 cfg.m_synch) == want


def _fake_library(monkeypatch, fits):
    """Stands in for the built kernel library on the wrapper's CUDA branch;
    returns the list of what sync_search_direct_fits was asked."""
    asked = []

    class Library:
        @staticmethod
        def sync_search_direct_fits(*args):
            asked.append(args)
            return fits

    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "library", Library)
    return asked


def test_direct_route_asks_the_library_whether_the_shape_fits(monkeypatch):
    """The kernel library owns the shared-memory layout: the wrapper asks
    its sync_search_direct_fits(stride, nfft, m_synch, nfft + cp) and raises
    ValueError on 0, before it builds K or launches anything."""
    cfg = port_cfg(G24)
    asked = _fake_library(monkeypatch, fits=0)
    monkeypatch.setattr(_cuda, "launch", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(sync_search, "_kernels_t",
                        lambda cfg: pytest.fail("built K"))
    before = dict(sync_search.route_launches)
    with pytest.raises(ValueError):
        sync_search.sync_corr_abs(cfg, torch.from_numpy(_noise(G24, 1, 5)), 9)
    assert asked == [(cfg.stride, cfg.nfft, cfg.m_synch, cfg.rx_b_len)]
    assert sync_search.route_launches == before


def test_cpu_tensor_takes_twin_and_counts_no_launch():
    cfg = port_cfg(L8)
    kernels.reset_launch_counts()
    before = dict(sync_search.route_launches)
    x = torch.from_numpy(_noise(L8, 2, seed=3))
    out = sync_search.sync_corr_abs(cfg, x, 12)
    assert torch.equal(out, fast_sync.sync_corr_abs_fast(cfg, x, 12))
    assert kernels.launch_counts()["sync_search"] == 0
    assert sync_search.route_launches == before


@pytest.mark.parametrize("cfg,entry", [
    (G24, "sync_search_direct"), (L8, "sync_search_fft"),
    (reduced(LTE1024, num_ofdm_symb=8, synch_dat=(2, 2)), "sync_search_fft"),
    (reduced(GOLDEN64, num_ofdm_symb=24, nfft=96, cp_len=24,
             num_synch_bins=94, stride=23), "sync_search_direct")],
    ids=["golden64", "lte1024", "lte1024-m_synch2", "nfft96"])
def test_wrapper_launches_by_the_route_rule(monkeypatch, cfg, entry):
    """The wrapper's CUDA branch with the launch recorded instead of run:
    the entry point the rule names, as many arguments as its C signature,
    one launch counted on that route, none for an empty batch."""
    pcfg = port_cfg(cfg)
    calls = []
    _fake_library(monkeypatch, fits=1)
    monkeypatch.setattr(_cuda, "launch",
                        lambda name, dev, *args: calls.append((name, args)))
    kernels.reset_launch_counts()
    before = dict(sync_search.route_launches)
    x = torch.from_numpy(_noise(cfg, 2, seed=4))
    out = sync_search.sync_corr_abs(pcfg, x, 9)
    assert out.shape == (2, 9, cfg.cp_len + 1) and out.dtype == torch.float32
    assert sync_search.sync_corr_abs(pcfg, x[0], 9).shape == (
        9, cfg.cp_len + 1)
    assert [name for name, _ in calls] == [entry, entry]
    for name, args in calls:
        assert len(args) + 1 == len(_cuda.SIGNATURES[name])
    kind = "fft" if entry.endswith("fft") else "direct"
    other = "direct" if kind == "fft" else "fft"
    assert kernels.launch_counts()["sync_search"] == 2
    assert sync_search.route_launches[kind] == before[kind] + 2
    assert sync_search.route_launches[other] == before[other]
    sync_search.sync_corr_abs(pcfg, x[:0], 9)
    sync_search.sync_corr_abs(pcfg, x, 0)
    assert len(calls) == 2
    kernels.reset_launch_counts()


def test_shape_no_route_takes_raises(monkeypatch):
    """On a CUDA tensor: the FFT kernel refuses an nfft it has no transform
    for and cp >= nfft, the direct kernel refuses taps that the library
    says do not fit in shared memory, an unknown route raises; nothing is
    launched."""
    calls = []
    _fake_library(monkeypatch, fits=0)
    monkeypatch.setattr(_cuda, "launch", lambda *a: calls.append(a))
    x = torch.zeros(1, 70000, dtype=torch.complex64)
    big = tparams.OFDMConfig(nfft=32768, cp_len=8192, num_ofdm_symb=4,
                             num_data_bins=1200, num_synch_bins=32766,
                             stride=8191)
    assert sync_search.route(big.nfft, big.cp_len, big.stride, 1) == "direct"
    with pytest.raises(ValueError):
        sync_search.sync_corr_abs(big, x, 1)
    n96 = port_cfg(reduced(GOLDEN64, nfft=96, cp_len=24, num_synch_bins=94))
    with pytest.raises(ValueError):
        sync_search._launch("fft", n96, x, 4)
    with pytest.raises(ValueError):
        sync_search._launch("fft", dataclasses.replace(
            tparams.GOLDEN64, nfft=16, cp_len=16, num_synch_bins=14,
            num_data_bins=12), x, 4)
    with pytest.raises(ValueError):
        sync_search._launch("conv", tparams.GOLDEN64, x, 4)
    with pytest.raises(ValueError):       # the Parseval form's premise
        sync_search.sync_corr_abs(dataclasses.replace(
            tparams.GOLDEN64, num_synch_bins=60), x, 4)
    assert calls == []


@CASES
def test_fft_form_edges(cfg):
    """A zero frame gives zeros (the 1e-30 floor), trials past the buffer
    take the zero-padded values, a 1-D buffer equals row 0 of the batch,
    and no trials give an empty result."""
    pcfg = port_cfg(cfg)
    x = torch.from_numpy(_noise(cfg, 2, seed=6))
    n_trials = sync.n_trials_for(pcfg, x.shape[1])
    x[1] = 0
    more = n_trials + 5
    out = fast_sync.sync_corr_abs_fft(pcfg, x, more)
    assert out.shape == (2, more, cfg.cp_len + 1)
    assert bool(torch.isfinite(out).all()) and not bool(out[1].any())
    padded = torch.nn.functional.pad(x, (0, 4 * cfg.rx_b_len + 5 * cfg.stride))
    np.testing.assert_allclose(
        out.numpy(), fast_sync.sync_corr_abs_fft(pcfg, padded, more).numpy(),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        out.numpy(), fast_sync.sync_corr_abs_fast(pcfg, padded, more).numpy(),
        atol=3e-3, rtol=2e-4)
    one = fast_sync.sync_corr_abs_fft(pcfg, x[0], more)
    assert one.shape == (more, cfg.cp_len + 1)
    np.testing.assert_allclose(one.numpy(), out[0].numpy(), atol=1e-5, rtol=0)
    assert fast_sync.sync_corr_abs_fft(pcfg, x, 0).shape == (
        2, 0, cfg.cp_len + 1)
    assert fast_sync.sync_corr_abs_fft(pcfg, x[0], 0).shape == (
        0, cfg.cp_len + 1)
