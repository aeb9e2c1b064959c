"""The plain twin of each ported kernel against the JAX package's function
(its Pallas kernel in interpret mode, or its XLA form at LTE scale), at the
tolerances of tests/test_pallas.py, and the wrappers' device dispatch.  The
kernels themselves are held to these twins on a CUDA device by
tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lte_gnu_radio_code_tpu.models import rxofdm as jrx
from lte_gnu_radio_code_tpu.ops import channel as jchan
from lte_gnu_radio_code_tpu.ops import fast_sync as jfs
from lte_gnu_radio_code_tpu.ops import modulation as jmodn
from lte_gnu_radio_code_tpu.ops import ofdm as jofdm
from lte_gnu_radio_code_tpu.pallas_kernels import channel_conv as jconv
from lte_gnu_radio_code_tpu.pallas_kernels import equalize as jeq
from lte_gnu_radio_code_tpu.pallas_kernels import ofdm_mod as jmod
from lte_gnu_radio_code_tpu.pallas_kernels import sync_search as jsearch
from lte_gnu_radio_code_tpu.utils.params import GOLDEN64, LTE1024, used_bins
from lte_gnu_radio_code_tpu_torch import kernels
from lte_gnu_radio_code_tpu_torch.kernels import (channel_conv, equalize,
                                                  ofdm_mod, sync_search)
from lte_gnu_radio_code_tpu_torch.ops import channel as tchan
from torch_parity import port_cfg, reduced, rx_buffer

G24 = reduced(GOLDEN64, num_ofdm_symb=24)
L8 = reduced(LTE1024, num_ofdm_symb=8)


def _grid_rows(cfg, frames, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(frames):
        bits = jnp.asarray(rng.integers(0, 2, cfg.num_bits, dtype=np.int32))
        pts = jmodn.bits_to_symbols(bits, cfg.modulation)
        rows.append(np.asarray(jofdm.resource_grid(
            cfg, pts.reshape(cfg.num_data_symb, cfg.num_data_bins))))
    return np.concatenate(rows)


def _cplx(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("cfg", [G24, L8], ids=["golden64", "lte1024"])
def test_k1_modulate_rows_twin_matches_jax(cfg):
    grid = _grid_rows(cfg, 2, seed=1)
    ref = np.asarray(jmod.modulate_rows(cfg, jnp.asarray(grid),
                                        interpret=True))
    out = ofdm_mod.modulate_rows(port_cfg(cfg), torch.from_numpy(grid))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)
    re, im = ofdm_mod.modulate_planar(port_cfg(cfg),
                                      torch.from_numpy(grid.real.copy()),
                                      torch.from_numpy(grid.imag.copy()))
    np.testing.assert_array_equal(re.numpy() + 1j * im.numpy(), out.numpy())


@pytest.mark.parametrize("cfg", [G24, L8], ids=["golden64", "lte1024"])
def test_k1_modulate_data_vals_twin_matches_jax(cfg):
    vals = _cplx(np.random.default_rng(2), 12, cfg.num_data_bins)
    _, bins = used_bins(cfg.nfft, cfg.num_data_bins)
    ref = np.asarray(jmod.modulate_data_vals(cfg, jnp.asarray(vals), bins,
                                             interpret=True))
    out = ofdm_mod.modulate_data_vals(port_cfg(cfg), torch.from_numpy(vals),
                                      bins)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("cfg,per_row", [(GOLDEN64, False), (GOLDEN64, True),
                                         (L8, True)],
                         ids=["golden64-per-bin", "golden64-per-row",
                              "lte1024-per-row"])
def test_k2_demod_windows_twin_matches_jax(cfg, per_row):
    x, _ = rx_buffer(cfg, seed=3)
    _, num_patterns = jrx.plan_rx(cfg, len(x))
    win = np.array(jeq.data_windows(cfg, jnp.asarray(x), cfg.cp_len,
                                    num_patterns))
    rng = np.random.default_rng(4)
    coeff = _cplx(rng, *((win.shape[0],) if per_row else ()),
                  cfg.num_data_bins)
    ref = np.asarray(jeq.demod_windows(cfg, jnp.asarray(win),
                                       jnp.asarray(coeff), interpret=True))
    out = equalize.demod_windows(port_cfg(cfg), torch.from_numpy(win),
                                 torch.from_numpy(coeff))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4)


@pytest.mark.parametrize("channel", ["Fading", "IMT16"])
def test_k3_channel_conv_twin_matches_jax(channel):
    x = _cplx(np.random.default_rng(9), 3, 2000)
    h = jchan.channel_taps(channel)
    ref = np.asarray(jconv.apply_channel_frames(jnp.asarray(x), h, 64))
    out = channel_conv.apply_channel_frames(torch.from_numpy(x), h, 64)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    full = channel_conv.conv_frames(torch.from_numpy(x), h)
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jconv.conv_frames(jnp.asarray(x), h)),
        atol=1e-5)


def test_k4_sync_search_twin_matches_jax_golden64():
    x, _ = rx_buffer(GOLDEN64, seed=2)
    n_trials, _ = jrx.plan_rx(GOLDEN64, len(x))
    ref = np.asarray(jsearch.sync_corr_abs(GOLDEN64, jnp.asarray(x),
                                           n_trials, interpret=True))
    out = sync_search.sync_corr_abs(port_cfg(GOLDEN64), torch.from_numpy(x),
                                    n_trials)
    assert out.shape == ref.shape == (n_trials, GOLDEN64.cp_len + 1)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-3)


def test_k4_sync_search_twin_matches_jax_lte1024():
    xs = np.stack([rx_buffer(L8, seed=s, snr_db=10.0)[0] for s in (5, 6)])
    n_trials, _ = jrx.plan_rx(L8, xs.shape[1])
    ref = np.asarray(jfs.sync_corr_abs_fast(L8, jnp.asarray(xs), n_trials))
    out = sync_search.sync_corr_abs(port_cfg(L8), torch.from_numpy(xs),
                                    n_trials)
    assert out.shape == ref.shape == (2, n_trials, L8.cp_len + 1)
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-3, rtol=2e-4)


def test_wrappers_take_twin_only_on_cpu():
    """CPU tensors run the twin and count no launch; a tensor on any other
    non-CUDA device raises instead of moving anywhere."""
    cfg = port_cfg(G24)
    kernels.reset_launch_counts()
    x = torch.zeros(2, 3000, dtype=torch.complex64)
    channel_conv.apply_channel_frames(x, tchan.channel_taps("Fading"), 64)
    sync_search.sync_corr_abs(cfg, x, 10)
    assert kernels.launch_counts() == dict.fromkeys(
        kernels.KERNEL_MODULES, 0)
    with pytest.raises(ValueError):
        sync_search.sync_corr_abs(cfg, x.to("meta"), 10)
    with pytest.raises(ValueError):
        equalize.demod_windows(cfg, torch.zeros(4, 64, dtype=torch.complex64),
                               torch.zeros(60, dtype=torch.complex64,
                                           device="meta"))
