"""K2: fused data demodulation — per-window DFT on the data bins, per-row
power normalisation, and the combined timing-derotation x MMSE coefficient.

Port of ``lte_gnu_radio_code_tpu/pallas_kernels/equalize.py``
(``demod_windows``, plus the plain-torch glue ``data_windows``,
``combined_coeff`` and ``equalize_data_symbols``).  The coefficient is any
per-bin complex factor: the single-lock RX passes derotation x MMSE gain,
the multi-detection and legacy receivers one row per window with their
masks folded in, and the pilot equaliser (``ops/pilots.py``) the rotation
alone, taking the power-normalised, derotated used-bin spectra back to
estimate the channel from them.  On a CPU tensor
:func:`demod_windows` runs the plain twin :func:`demod_windows_plain` (the
DFT on the data bins as a product with the ``[nfft, B]`` basis).  On a CUDA
tensor it launches the shared-memory FFT kernel ``equalize_fft``
(``csrc/equalize.cu``) for a power-of-two nfft in [16, 4096] and raises
``ValueError`` for any other (``kernels/fft.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import sync as sync_ops
from ..utils.params import OFDMConfig, used_bins
from ..utils.tables import device_table
from . import _cuda, fft

launches = 0   # kernel launches since the last reset


@functools.lru_cache(maxsize=16)
def _dft_bins_mats(nfft: int, num_bins: int) -> np.ndarray:
    """[nfft, B] e^{-j 2pi b_k n / N} on the data bins
    (``equalize._dft_bins_mats``)."""
    _, bins = used_bins(nfft, num_bins)
    n = np.arange(nfft)
    return np.exp(-2j * np.pi * np.outer(n, np.asarray(bins)) / nfft
                  ).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _bin_index(nfft: int, num_bins: int) -> np.ndarray:
    """[B] int32 wrapped FFT indices of the data bins, in used_bins order."""
    return np.asarray(used_bins(nfft, num_bins)[1], np.int32)


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
    k, nb, nfft, dev = win.shape[0], cfg.num_data_bins, cfg.nfft, win.device
    fft.require(nfft)
    _cuda.check(win, "win", torch.complex64, (k, nfft))
    _cuda.check(coeff, "coeff", torch.complex64,
                (nb,) if coeff.ndim == 1 else (k, nb))
    if nb % 2:
        raise ValueError(f"num_data_bins {nb}: used_bins needs an even "
                         "count")
    ld = 0 if coeff.ndim == 1 else nb
    out = torch.empty(k, nb, dtype=torch.complex64, device=dev)
    if not k:
        return out
    win, coeff = _cuda.aligned(win), _cuda.aligned(coeff)
    idx = device_table(_bin_index, dev, nfft, nb)
    tw = device_table(fft.twiddles, dev, nfft)
    _cuda.launch("equalize_fft", dev, win.data_ptr(), idx.data_ptr(),
                 tw.data_ptr(), coeff.data_ptr(), ld, out.data_ptr(), k, nfft,
                 nb)
    launches += 1
    return out


def data_windows(cfg: OFDMConfig, x: torch.Tensor, lock_ptr,
                 num_patterns: int) -> torch.Tensor:
    """[..., K = num_patterns*nd, nfft] data-symbol windows at each frame's
    lock (x [..., n], lock_ptr [...])."""
    return sync_ops.windows_at(x, lock_ptr, device_table(
        sync_ops.data_window_offsets, x.device, cfg, num_patterns))


def derotation(cfg: OFDMConfig, delay_idx, device) -> torch.Tensor:
    """[..., B] timing derotation e^{+j 2 pi d b_k / N} of each lock's delay
    d on the data bins."""
    return sync_ops.derotation(cfg.nfft, delay_idx, device_table(
        sync_ops._bins, device, cfg.nfft, cfg.num_data_bins))


def combined_coeff(cfg: OFDMConfig, delay_idx,
                   chan_full: torch.Tensor) -> torch.Tensor:
    """[..., B] per-bin derotation x MMSE coefficient of each frame's lock."""
    bins = device_table(sync_ops._bins, chan_full.device, cfg.nfft,
                        cfg.num_data_bins)
    return derotation(cfg, delay_idx, chan_full.device) * sync_ops.mmse_gain(
        chan_full[..., bins], cfg.snr_linear)


def demod_frames(cfg: OFDMConfig, win: torch.Tensor, coeff: torch.Tensor,
                 demod=None) -> torch.Tensor:
    """win [..., K, nfft] windows of each frame and coeff [..., B], one
    coefficient row a frame -> [..., K, B], as one call of ``demod``
    (:func:`demod_windows` unless given) over the flattened windows.  K2
    takes contiguous rows, and with one frame the expanded coefficients
    would stay a strided view, hence the copy."""
    demod = demod or demod_windows
    if coeff.ndim == 1:
        return demod(cfg, win, coeff.contiguous())
    nb = coeff.shape[-1]
    rows = coeff[..., None, :].expand(*win.shape[:-1], nb)
    return demod(cfg, win.reshape(-1, cfg.nfft),
                 rows.reshape(-1, nb).contiguous()).reshape(
                     *win.shape[:-1], nb)


def equalize_data_symbols(cfg: OFDMConfig, x: torch.Tensor, lock_ptr,
                          delay_idx, chan_full: torch.Tensor,
                          num_patterns: int) -> torch.Tensor:
    """FFT + power norm + timing derotation + MMSE EQ of every data symbol
    at each frame's lock through K2 (``sync.py:equalize_data_symbols``):
    x [..., n], one lock per frame, one launch for every frame."""
    win = data_windows(cfg, x, lock_ptr, num_patterns)
    return demod_frames(cfg, win, combined_coeff(cfg, delay_idx, chan_full))
