"""K2: fused data demodulation — per-window DFT on the data bins, per-row
power normalisation, and the combined timing-derotation x MMSE coefficient.

Port of ``lte_gnu_radio_code_tpu/pallas_kernels/equalize.py``
(``demod_windows``, plus the plain-torch glue ``data_windows``,
``combined_coeff`` and ``equalize_data_symbols``).  On a CUDA tensor
:func:`demod_windows` launches ``csrc/equalize.cu``; on a CPU tensor it runs
the plain twin :func:`demod_windows_plain`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import sync as sync_ops
from ..utils.params import OFDMConfig, used_bins
from ..utils.tables import device_table
from . import _cuda

launches = 0          # kernel launches since the last reset


@functools.lru_cache(maxsize=16)
def _dft_bins_mats(nfft: int, num_bins: int) -> np.ndarray:
    """[nfft, B] e^{-j 2pi b_k n / N} on the data bins
    (``equalize._dft_bins_mats``)."""
    _, bins = used_bins(nfft, num_bins)
    n = np.arange(nfft)
    return np.exp(-2j * np.pi * np.outer(n, np.asarray(bins)) / nfft
                  ).astype(np.complex64)


def demod_windows_plain(cfg: OFDMConfig, win: torch.Tensor,
                        coeff: torch.Tensor) -> torch.Tensor:
    """Plain twin of K2: [K, nfft] windows, coeff [B] or [K, B] -> [K, B]."""
    _cuda.require_fp32(win.device)
    v = device_table(_dft_bins_mats, win.device, cfg.nfft, cfg.num_data_bins)
    f = win @ v
    power = (f.real ** 2 + f.imag ** 2).sum(1, keepdim=True)
    scale = float(np.sqrt(np.float32(cfg.num_data_bins))) * torch.rsqrt(
        power.clamp_min(1e-30))
    return f * scale * coeff


def demod_windows(cfg: OFDMConfig, win: torch.Tensor,
                  coeff: torch.Tensor) -> torch.Tensor:
    """[K, nfft] complex windows + combined coeff ([B] for every window, or
    [K, B] one per window) -> [K, B] equalised phasors."""
    global launches
    if _cuda.on_cpu(win, coeff):
        return demod_windows_plain(cfg, win, coeff)
    k, nb = win.shape[0], cfg.num_data_bins
    _cuda.check(win, "win", torch.complex64, (k, cfg.nfft))
    _cuda.check(coeff, "coeff", torch.complex64,
                (nb,) if coeff.ndim == 1 else (k, nb))
    v = device_table(_dft_bins_mats, win.device, cfg.nfft, nb)
    out = torch.empty(k, nb, dtype=torch.complex64, device=win.device)
    if k:
        _cuda.launch("equalize_demod", win.device, win.data_ptr(),
                     v.data_ptr(), coeff.data_ptr(),
                     0 if coeff.ndim == 1 else nb, out.data_ptr(), k,
                     cfg.nfft, nb)
        launches += 1
    return out


def data_windows(cfg: OFDMConfig, x: torch.Tensor, lock_ptr,
                 num_patterns: int) -> torch.Tensor:
    """[..., K = num_patterns*nd, nfft] data-symbol windows at each frame's
    lock (x [..., n], lock_ptr [...])."""
    return sync_ops.windows_at(x, lock_ptr, device_table(
        sync_ops.data_window_offsets, x.device, cfg, num_patterns))


def combined_coeff(cfg: OFDMConfig, delay_idx,
                   chan_full: torch.Tensor) -> torch.Tensor:
    """[..., B] per-bin derotation x MMSE coefficient of each frame's lock."""
    bins = device_table(sync_ops._bins, chan_full.device, cfg.nfft,
                        cfg.num_data_bins)
    delay = torch.as_tensor(delay_idx, device=chan_full.device)
    rot = torch.exp((1j * 2.0 * np.pi / cfg.nfft) *
                    delay.to(torch.float32)[..., None] *
                    bins.to(torch.float32))
    return rot * sync_ops.mmse_gain(chan_full[..., bins], cfg.snr_linear)


def equalize_data_symbols(cfg: OFDMConfig, x: torch.Tensor, lock_ptr,
                          delay_idx, chan_full: torch.Tensor,
                          num_patterns: int) -> torch.Tensor:
    """Drop-in for ops.sync.equalize_data_symbols of one frame through K2."""
    win = data_windows(cfg, x, lock_ptr, num_patterns)
    coeff = combined_coeff(cfg, delay_idx, chan_full)
    return demod_windows(cfg, win, coeff.contiguous())
