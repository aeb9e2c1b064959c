"""Each hand-written CUDA kernel of the port against its plain PyTorch twin,
and the loopback chain through them, on a CUDA device; every test skips
without one.  Imports no JAX, so it also runs on a GPU host that has none
(``--noconftest`` skips tests/conftest.py, which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu_torch import kernels
from lte_gnu_radio_code_tpu_torch.kernels import (_cuda, channel_conv,
                                                  equalize, ofdm_mod,
                                                  sync_search)
from lte_gnu_radio_code_tpu_torch.models import chain, rxofdm, txofdm
from lte_gnu_radio_code_tpu_torch.ops import channel
from lte_gnu_radio_code_tpu_torch.utils.params import (GOLDEN64, LTE1024,
                                                       LTE2048, used_bins)

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


def _frames(cfg, dev, batch, seed):
    """Seeded frames through the plain TX and the Fading channel."""
    bits = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2, (batch, cfg.num_bits), dtype=np.int32)).to(dev)
    tx = txofdm.tx_frames(cfg, bits)
    return bits, channel.apply_channel(tx, chain.loopback_taps(cfg),
                                       max_impulse=cfg.nfft)


@CFGS
def test_k1_matches_twin(dev, cfg):
    bits, _ = _frames(cfg, dev, 3, seed=1)
    grid = txofdm._grid(cfg, bits).reshape(-1, cfg.nfft)
    w = torch.from_numpy(ofdm_mod._idft_mats(cfg.nfft)).to(dev)
    before = ofdm_mod.launches
    out = ofdm_mod.modulate_rows(cfg, grid)
    assert ofdm_mod.launches == before + 1
    torch.testing.assert_close(out, ofdm_mod.mod_rows_plain(cfg, grid, w),
                               atol=2e-5, rtol=0)
    vals = _cplx(dev, 2, 50, cfg.num_data_bins)
    _, bins = used_bins(cfg.nfft, cfg.num_data_bins)
    wb = torch.from_numpy(ofdm_mod._idft_bin_mats(cfg.nfft, bins)).to(dev)
    torch.testing.assert_close(ofdm_mod.modulate_data_vals(cfg, vals, bins),
                               ofdm_mod.mod_rows_plain(cfg, vals, wb),
                               atol=2e-5, rtol=0)


@CFGS
@pytest.mark.parametrize("per_row", [False, True], ids=["per-bin", "per-row"])
def test_k2_matches_twin(dev, cfg, per_row):
    win = _cplx(dev, 3, 70, cfg.nfft)
    coeff = _cplx(dev, 4, *((70,) if per_row else ()), cfg.num_data_bins)
    torch.testing.assert_close(
        equalize.demod_windows(cfg, win, coeff),
        equalize.demod_windows_plain(cfg, win, coeff), atol=2e-4, rtol=0)


@pytest.mark.parametrize("name", ["Fading", "IMT16", "Ideal"])
def test_k3_matches_twin(dev, name):
    x = _cplx(dev, 5, 3, 5000)
    h = channel.channel_taps(name)
    out = channel_conv.apply_channel_frames(x, h, 64)
    assert out.shape == (3, 5063)
    torch.testing.assert_close(
        out, channel_conv.apply_channel_frames_plain(x, h, 64), atol=1e-5,
        rtol=0)


@CFGS
def test_k4_matches_twin(dev, cfg):
    _, xs = _frames(cfg, dev, 2, seed=6)
    n_trials, _ = rxofdm.plan_rx(cfg, xs.shape[1])
    out = sync_search.sync_corr_abs(cfg, xs, n_trials)
    torch.testing.assert_close(
        out, sync_search.sync_corr_abs_plain(cfg, xs, n_trials), atol=3e-3,
        rtol=2e-4)
    torch.testing.assert_close(sync_search.sync_corr_abs(cfg, xs[1], n_trials),
                               out[1], atol=0, rtol=0)


def test_chain_batch_through_kernels(dev):
    cfg = G24
    n_samples = cfg.frame_len + cfg.nfft - 1
    n_trials, num_patterns = rxofdm.plan_rx(cfg, n_samples)
    bits, _ = _frames(cfg, dev, 4, seed=7)
    noise = _cplx(dev, 8, 4, n_samples)
    h = chain.loopback_taps(cfg)
    kernels.reset_launch_counts()
    r = chain.chain_batch(cfg, h, n_trials, num_patterns, bits, noise=noise)
    assert all(n == 1 for n in kernels.launch_counts().values())
    assert bool(r.found.all()) and float(r.ber.max()) == 0.0
    p = chain.chain_batch(cfg, h, n_trials, num_patterns, bits, noise=noise,
                          plain=True)
    assert torch.equal(r.hard_bits, p.hard_bits)


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
