"""Carrier-frequency-offset hypothesis search and DSSS despreading in torch.

Port of ``lte_gnu_radio_code_tpu/ops/cfo.py`` (``cfo_bank``, ``dsss_code``,
``cfo_search_scan``, ``bank_select``, ``spectra_at_detections``,
``sync_spectra_cfo``, ``sync_correlate_cfo``, ``dsss_despread``).  The
legacy receivers multiply each trial window by every CFO mixer candidate
before the FFT and keep the (fo, delay) pair of the largest correlation.
The mixer runs over each window's own index 0..nfft-1, so the search is not
a mix of the stream: it stays batched ``torch.fft``, one candidate at a
time.  Windows come from ``ops.sync.windows_at``.  Every function takes
leading stream dimensions; ``bank`` is a tensor on x's device
(:func:`bank_on`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.params import OFDMConfig
from ..utils.tables import device_table
from . import sync
from .zadoff_chu import zadoff_chu


def cfo_bank(cfg: OFDMConfig, fo_range) -> np.ndarray:
    """[F, nfft] mixer bank exp(+j 2 pi fo / fs n) (``cfo.py:cfo_bank``)."""
    return np.exp(1j * 2 * np.pi * (1.0 / cfg.fs) *
                  np.outer(np.asarray(fo_range, np.float64),
                           np.arange(cfg.nfft))).astype(np.complex64)


def bank_on(cfg: OFDMConfig, fo_range, device) -> torch.Tensor:
    """:func:`cfo_bank` as a tensor on ``device``, made once per device."""
    return device_table(cfo_bank, torch.device(device), cfg,
                        tuple(float(f) for f in fo_range))


def dsss_code(dsss: int, prime: int = 37) -> np.ndarray:
    """ZC spreading code of length ``dsss`` (``cfo.py:dsss_code``)."""
    return zadoff_chu(dsss, prime, parity_even=(dsss % 2 == 0))


def _normalised_synch_bins(cfg: OFDMConfig, f: torch.Tensor) -> torch.Tensor:
    """[..., m_synch, nfft] window spectra -> [..., m_synch*L] synch-bin
    values at unit mean power (the power clamped at 1e-30)."""
    s = f[..., sync._bins_on(f.device, cfg.nfft, cfg.num_synch_bins)]
    s = s.reshape(*s.shape[:-2], -1)
    power = (s.abs() ** 2).sum(-1, keepdim=True)
    return s * torch.sqrt(s.shape[-1] / power.clamp_min(1e-30))


@functools.lru_cache(maxsize=16)
def _trial_index(cfg: OFDMConfig, n_trials: int) -> np.ndarray:
    """[n_trials, m_synch, nfft] sample index of every synch window of the
    stride-spaced trials."""
    starts = cfg.cp_len + cfg.stride * np.arange(n_trials)
    return starts[:, None, None] + sync._synch_window_offsets(cfg)[None]


def _trial_windows(cfg: OFDMConfig, x: torch.Tensor,
                   n_trials: int) -> torch.Tensor:
    """x [..., n] -> [..., n_trials, m_synch, nfft] synch windows of the
    stride-spaced trials.  The index table is made once per device, so a
    chunk step copies nothing from the host."""
    return x[..., device_table(_trial_index, x.device, cfg, n_trials)]


def cfo_search_scan(cfg: OFDMConfig, x: torch.Tensor, n_trials: int,
                    bank: torch.Tensor):
    """Running-max CFO hypothesis search (``cfo.py:cfo_search_scan``): a
    loop over the few candidates that holds one candidate's spectra at a
    time.  A later candidate replaces the best only where it is strictly
    larger, so the first candidate wins ties, and within a candidate the
    first delay does, as a flat argmax over the fo-major cube would.

    x [..., n], bank [F, nfft] -> (dmax_val [..., p] float32, delay_win
    [..., p] int32, fo_win [..., p] int32)."""
    win = _trial_windows(cfg, x, n_trials)
    best_val = best_delay = best_fo = None
    for k, fo_row in enumerate(bank):
        s = _normalised_synch_bins(
            cfg, torch.fft.fft(win * fo_row, cfg.nfft, dim=-1))
        val, dly = sync.sync_correlate_ifft(cfg, s).abs().max(-1)
        dly = dly.to(torch.int32)
        if best_val is None:
            best_val, best_delay = val, dly
            best_fo = torch.zeros_like(dly)
        else:
            upd = val > best_val
            best_val = torch.where(upd, val, best_val)
            best_delay = torch.where(upd, dly, best_delay)
            best_fo = torch.where(upd, k, best_fo)
    return best_val, best_delay, best_fo


def bank_select(bank: torch.Tensor, fo_sel: torch.Tensor) -> torch.Tensor:
    """bank[fo_sel]: fo_sel [...] -> [..., nfft] (``cfo.py:bank_select``; a
    plain index, as an ``index_select`` so that no index leaves the
    device)."""
    return bank.index_select(0, fo_sel.reshape(-1).to(torch.int64)).reshape(
        *fo_sel.shape, bank.shape[-1])


def spectra_at_detections(cfg: OFDMConfig, x: torch.Tensor,
                          ptrs: torch.Tensor, fo_sel: torch.Tensor,
                          bank: torch.Tensor) -> torch.Tensor:
    """The power-normalised synch spectra at the detections only, each
    mixed with its winning CFO candidate (``cfo.py:spectra_at_detections``):
    x [..., n], ptrs and fo_sel [..., D] -> [..., D, m_synch*L]."""
    win = sync.windows_at(x, ptrs, device_table(sync._synch_window_offsets,
                                                x.device, cfg))
    mixed = win * bank_select(bank, fo_sel)[..., None, :]
    return _normalised_synch_bins(cfg,
                                  torch.fft.fft(mixed, cfg.nfft, dim=-1))


def sync_spectra_cfo(cfg: OFDMConfig, x: torch.Tensor, n_trials: int,
                     bank: torch.Tensor) -> torch.Tensor:
    """Power-normalised synch-bin spectra of every (trial, fo) pair, the
    whole cube at once (``cfo.py:sync_spectra_cfo``): x [..., n] -> [...,
    n_trials, F, m_synch*L]."""
    win = _trial_windows(cfg, x, n_trials)
    mixed = win[..., None, :, :] * bank[:, None, :]
    return _normalised_synch_bins(cfg,
                                  torch.fft.fft(mixed, cfg.nfft, dim=-1))


def sync_correlate_cfo(cfg: OFDMConfig,
                       spectra: torch.Tensor) -> torch.Tensor:
    """The delay correlation over the (trial, fo, delay) cube
    (``cfo.py:sync_correlate_cfo``): spectra [..., p, F, m_synch*L] ->
    [..., p, F, cp+1], one inverse FFT per (trial, fo) pair."""
    return sync.sync_correlate_ifft(cfg, spectra)


def dsss_despread(phasors: torch.Tensor, dsss: int) -> torch.Tensor:
    """[..., B] equalised chips -> [..., B/dsss] despread symbols: the mean
    over each chip group of chips * conj(code) (``cfo.py:dsss_despread``),
    every detection of the table in one pass."""
    if dsss == 1:
        return phasors
    sc = device_table(dsss_code, phasors.device, dsss)
    chips = phasors.reshape(*phasors.shape[:-1], -1, dsss)
    return (chips * sc.conj()).mean(-1)
