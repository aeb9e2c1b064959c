"""The delay-search correlation as a bank of real convolutions plus
sliding-window Parseval normalisation, in torch: the plain twin of K4.

Port of ``lte_gnu_radio_code_tpu/ops/fast_sync.py`` (``_kernels``,
``sync_corr_abs_fast``); its docstring derives the formulation.  Per trial
p and delay d, corr[p, d] = sum_m x[cp + p*stride + m] K_d[m], and the
synch-bin power is sum_l (N E_l - |DC_l|^2 - |NY_l|^2) over length-N box
sums of |x|^2, x and (-1)^n x (valid when num_synch_bins == nfft - 2).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import _cuda
from ..utils.params import OFDMConfig, used_bins
from ..utils.tables import device_table
from .zadoff_chu import zc_for_config


@functools.lru_cache(maxsize=32)
def _kernels(cfg: OFDMConfig) -> np.ndarray:
    """[cp+1, klen] complex64 correlation kernels K_d
    (``fast_sync._kernels``):  K_d[l (N+cp) + n] =
    sum_k e^{-j 2pi b_k (n - d) / N} conj(ZC[l L + k]), computed as one
    [cp+1, L] x [L, N] product per synch symbol l."""
    nfft, cp, m0 = cfg.nfft, cfg.cp_len, cfg.m_synch
    _, bins_p = used_bins(nfft, cfg.num_synch_bins)
    b = np.asarray(bins_p)
    zc = zc_for_config(cfg).astype(np.complex128)
    L = cfg.num_synch_bins
    klen = (m0 - 1) * cfg.rx_b_len + nfft
    out = np.zeros((cp + 1, klen), dtype=np.complex128)
    delay = np.exp(2j * np.pi * np.outer(np.arange(cp + 1), b) / nfft)
    time = np.exp(-2j * np.pi * np.outer(b, np.arange(nfft)) / nfft)
    for l in range(m0):
        coeff = np.conj(zc[l * L:(l + 1) * L])
        out[:, l * cfg.rx_b_len: l * cfg.rx_b_len + nfft] = (
            delay * coeff) @ time
    return out.astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _conv_weights(cfg: OFDMConfig) -> np.ndarray:
    """[2D, 2, klen] real conv weights: out channels [re x D, im x D]."""
    k = _kernels(cfg)
    d = k.shape[0]
    w = np.zeros((2 * d, 2, k.shape[1]), np.float32)
    w[:d, 0], w[:d, 1] = k.real, -k.imag          # re = xr*kr - xi*ki
    w[d:, 0], w[d:, 1] = k.imag, k.real           # im = xr*ki + xi*kr
    return w


def _box_sums(x: torch.Tensor, nfft: int, stride: int):
    """Length-nfft box sums of |x|^2, x and (-1)^n x over [B, n] ->
    (e, dc2, ny2), each [B, (n - nfft)//stride + 1]."""
    sgn = torch.ones(x.shape[-1], device=x.device)
    sgn[1::2] = -1.0
    feats = torch.stack([x.real ** 2 + x.imag ** 2, x.real, x.imag,
                         x.real * sgn, x.imag * sgn], 1)      # [B, 5, n]
    ones = torch.ones(5, 1, nfft, device=x.device)
    s = F.conv1d(feats, ones, stride=stride, groups=5)
    return (s[:, 0], s[:, 1] ** 2 + s[:, 2] ** 2,
            s[:, 3] ** 2 + s[:, 4] ** 2)


def sync_corr_abs_fast(cfg: OFDMConfig, x: torch.Tensor,
                       n_trials: int) -> torch.Tensor:
    """|corr| [B, n_trials, cp+1] for x [B, n] ([n_trials, cp+1] for x [n])
    (``fast_sync.sync_corr_abs_fast``)."""
    if cfg.num_synch_bins != cfg.nfft - 2:
        raise ValueError("Parseval normalisation requires the canonical "
                         "all-but-DC/Nyquist synch bins")
    squeeze = x.ndim == 1
    x = x.reshape(-1, x.shape[-1])
    _cuda.require_fp32(x.device)
    w = device_table(_conv_weights, x.device, cfg)
    d = w.shape[0] // 2
    L = cfg.m_synch * cfg.num_synch_bins
    cp, s = cfg.cp_len, cfg.stride
    # the strided form starts at the first trial and computes only trial
    # offsets; every tensor below is indexed by trial
    xt = x[:, cp:]
    xr = torch.stack([xt.real, xt.imag], 1)                    # [B, 2, n]
    y = F.conv1d(xr, w, stride=s)[:, :, :n_trials]
    corr = torch.complex(y[:, :d], y[:, d:]).transpose(1, 2)   # [B, p, D]
    s_pow = 0.0
    for l in range(cfg.m_synch):
        e, dc2, ny2 = _box_sums(xt[:, l * cfg.rx_b_len:], cfg.nfft, s)
        s_pow = s_pow + (cfg.nfft * e - dc2 - ny2)[:, :n_trials]
    scale = torch.sqrt(L / torch.clamp(s_pow, min=1e-30))
    out = corr.abs() * scale[..., None]
    return out[0] if squeeze else out
