"""The delay-search correlation as a bank of real convolutions plus
sliding-window Parseval normalisation, in torch: the plain twin of K4.

Port of ``lte_gnu_radio_code_tpu/ops/fast_sync.py`` (``_kernels``,
``sync_corr_abs_fast``); its docstring derives the formulation.  Per trial
p and delay d, corr[p, d] = sum_m x[cp + p*stride + m] K_d[m], and the
synch-bin power is sum_l (N E_l - |DC_l|^2 - |NY_l|^2) over length-N box
sums of |x|^2, x and (-1)^n x (valid when num_synch_bins == nfft - 2).

:func:`sync_corr_abs_fft` is the same function in its FFT form, batched
over frames and trials: K_d is a circular shift by d of one length-N
sequence, so a trial's row of delays is the forward FFT of each synch
window, a multiply by conj(ZC) on the synch bins and one inverse FFT
(the JAX package's ``sync_spectra`` + ``sync_correlate_ifft`` in one
pass).
It is the plain version of K4's FFT route; nothing on the main path calls
it.

Both take an optional ZC sequence ``zc`` (default ``zc_for_config(cfg)``,
of length m_synch * num_synch_bins): the MIMO receivers search with one
slice of a longer sequence (``models/mimo.py``).  Every table built from
it is cached on the config and :func:`zc_key`, the sequence's bytes.
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


def zc_key(zc) -> bytes | None:
    """The cache key of a ZC sequence: its complex64 bytes; None stands for
    the config's own sequence."""
    if zc is None:
        return None
    return np.ascontiguousarray(zc, np.complex64).tobytes()


def _zc_of(cfg: OFDMConfig, key: bytes | None) -> np.ndarray:
    """The ZC sequence a :func:`zc_key` stands for, checked against the
    config's m_synch * num_synch_bins."""
    if key is None:
        return zc_for_config(cfg)
    zc = np.frombuffer(key, np.complex64)
    if len(zc) != cfg.m_synch * cfg.num_synch_bins:
        raise ValueError(f"ZC sequence of {len(zc)} samples: the search "
                         f"correlates {cfg.m_synch} x {cfg.num_synch_bins}")
    return zc


@functools.lru_cache(maxsize=32)
def _kernels(cfg: OFDMConfig, key: bytes | None = None) -> np.ndarray:
    """[cp+1, klen] complex64 correlation kernels K_d
    (``fast_sync._kernels``):  K_d[l (N+cp) + n] =
    sum_k e^{-j 2pi b_k (n - d) / N} conj(ZC[l L + k]), computed as one
    [cp+1, L] x [L, N] product per synch symbol l."""
    nfft, cp, m0 = cfg.nfft, cfg.cp_len, cfg.m_synch
    _, bins_p = used_bins(nfft, cfg.num_synch_bins)
    b = np.asarray(bins_p)
    zc = _zc_of(cfg, key).astype(np.complex128)
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
def _conv_weights(cfg: OFDMConfig, key: bytes | None = None) -> np.ndarray:
    """[2D, 2, klen] real conv weights: out channels [re x D, im x D]."""
    k = _kernels(cfg, key)
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


def sync_corr_abs_fast(cfg: OFDMConfig, x: torch.Tensor, n_trials: int,
                       zc=None) -> torch.Tensor:
    """|corr| [..., n_trials, cp+1] for x [..., n]
    (``fast_sync.sync_corr_abs_fast``), against ``zc`` (module
    docstring)."""
    if cfg.num_synch_bins != cfg.nfft - 2:
        raise ValueError("Parseval normalisation requires the canonical "
                         "all-but-DC/Nyquist synch bins")
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    _cuda.require_fp32(x.device)
    w = device_table(_conv_weights, x.device, cfg, zc_key(zc))
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
    return out.reshape(*lead, *out.shape[1:])


@functools.lru_cache(maxsize=32)
def _zc_by_bin(cfg: OFDMConfig, key: bytes | None = None) -> np.ndarray:
    """[m_synch, nfft] complex64: conj(ZC[l L + k]) at FFT index b_k of
    synch window l, zero off the synch bins."""
    L = cfg.num_synch_bins
    bins = np.asarray(used_bins(cfg.nfft, L)[1])
    out = np.zeros((cfg.m_synch, cfg.nfft), np.complex64)
    out[:, bins] = np.conj(_zc_of(cfg, key)).reshape(cfg.m_synch, L)
    return out


def sync_corr_abs_fft(cfg: OFDMConfig, x: torch.Tensor, n_trials: int,
                      zc=None) -> torch.Tensor:
    """|corr| [..., n_trials, cp+1] for x [..., n] in the FFT form: per
    trial, |N ifft(sum_l fft(window_l) conj(ZC_l))[d]| * sqrt(L /
    max(sum_l sum_k |fft(window_l)[b_k]|^2, 1e-30)), d <= cp.
    Samples past the buffer read as zeros; ``zc`` as in the module
    docstring.  Computes in x's precision
    (complex64, or complex128 for a float64 evaluation)."""
    if cfg.cp_len >= cfg.nfft:
        raise ValueError("the FFT form reads delays 0..cp from one "
                         "length-nfft inverse: it needs cp < nfft")
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    nfft, cp, s, m0 = cfg.nfft, cfg.cp_len, cfg.stride, cfg.m_synch
    if not n_trials:
        return x.real.new_zeros(*lead, 0, cp + 1)
    need = cp + (n_trials - 1) * s + (m0 - 1) * cfg.rx_b_len + nfft
    if need > x.shape[1]:
        x = F.pad(x, (0, need - x.shape[1]))
    zc = device_table(_zc_by_bin, x.device, cfg, zc_key(zc)).to(x.dtype)
    on_bins = zc[0] != 0
    y, power = 0.0, 0.0
    for l in range(m0):
        win = x[:, cp + l * cfg.rx_b_len:].unfold(1, nfft, s)[:, :n_trials]
        f = torch.fft.fft(win, dim=-1)                       # [B, p, N]
        power = power + (f.real ** 2 + f.imag ** 2)[..., on_bins].sum(-1)
        y = y + f * zc[l]
    corr = nfft * torch.fft.ifft(y, dim=-1)[..., : cp + 1]
    L = m0 * cfg.num_synch_bins
    out = corr.abs() * torch.sqrt(L / power.clamp_min(1e-30))[..., None]
    return out.reshape(*lead, *out.shape[1:])
