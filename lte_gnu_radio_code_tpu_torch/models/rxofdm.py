"""RX model in torch: sync search -> first lock -> channel estimate ->
data demod -> LLR demap.

Port of ``lte_gnu_radio_code_tpu/models/rxofdm.py`` (``rx_frame``,
``rx_frames_batch``, ``plan_rx``, ``make_rx``) for every modulation and
pilot grid: QPSK keeps the reference's biased LLR demap with its per-frame
sigma; QAM removes the MMSE amplitude bias and takes max-log LLRs; with a
pilot grid the synch lock gives the timing and the scattered pilots the
channel (``ops/pilots.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import equalize, sync_search
from ..ops import fast_sync, modulation, pilots, sync
from ..utils import profiling
from ..utils.params import OFDMConfig


class RxResult(NamedTuple):
    phasors: torch.Tensor        # [num_data_symb, num_data_bins] equalised
    hard_bits: torch.Tensor      # [num_bits]
    llr0: torch.Tensor
    llr1: torch.Tensor
    lock_ptr: torch.Tensor       # frame pointer of the sync lock
    delay_idx: torch.Tensor      # winning delay hypothesis
    peak: torch.Tensor           # correlation peak value
    found: torch.Tensor          # gate crossed anywhere
    chan_est_time: torch.Tensor  # [nfft] estimated CIR


class BatchRxResult(NamedTuple):
    hard_bits: torch.Tensor      # [B, num_bits]
    found: torch.Tensor          # [B]
    lock_ptr: torch.Tensor       # [B]
    delay_idx: torch.Tensor      # [B]
    phasors: torch.Tensor        # [B, num_data_symb, num_data_bins]


def demap(cfg: OFDMConfig, phasors: torch.Tensor, h_data: torch.Tensor):
    """Equalised phasors [..., K, B] of each frame and the channel at their
    bins [..., B] -> (phasors, hard, llr0, llr1), the last three [...,
    K*B*bits_per_bin] (``rxofdm.rx_frame``'s last step).  QPSK: the
    reference's LLR demap, its sigma a mean over each frame alone.  Any
    other modulation: the MMSE amplitude bias is taken out of the phasors,
    then max-log LLRs at noise variance 1 / snr_linear, llr0, llr1 = -llr,
    llr."""
    lead = phasors.shape[:-2]
    if cfg.modulation == "QPSK":
        hard, llr0, llr1 = modulation.qpsk_llr_frames(
            phasors.reshape(-1, *phasors.shape[-2:]))
    else:
        phasors = phasors * sync.demap_unbias_gain(
            h_data, cfg.snr_linear)[..., None, :]
        hard, llr = modulation.maxlog_llr(phasors, cfg.modulation,
                                          1.0 / cfg.snr_linear)
        llr0, llr1 = -llr, llr
    return (phasors, *(v.reshape(*lead, -1) for v in (hard, llr0, llr1)))


def rx_frame(cfg: OFDMConfig, x: torch.Tensor, n_trials: int,
             num_patterns: int, fast: str | None = None, genie_h=None,
             perfect_chan_est: bool = False,
             eq: str | None = None) -> RxResult:
    """Demodulate one buffer x [n], or one buffer per frame x [..., n] with
    every result carrying the leading frame axes (``rxofdm.rx_frame``, and
    ``jax.vmap`` of it).

    ``fast`` selects the delay search: None / "ifft" (trial FFTs + one
    inverse FFT per trial), "exact" (the dense delay matmul), "conv" (the
    conv-bank, ``ops.fast_sync``) or "kernel" (K4).  ``eq`` None runs the
    FFT equaliser, "kernel" K2; with a pilot grid it selects the same two
    forms of the pilot equaliser.  ``perfect_chan_est`` substitutes the true
    channel ``genie_h`` (a CIR) for the synch-symbol estimate."""
    if eq not in (None, "kernel"):
        raise ValueError(f"unknown equaliser path {eq!r}")
    fast = fast or "ifft"
    if fast in ("ifft", "exact"):
        spectra = sync.sync_spectra(cfg, x, n_trials)
        corr = sync.corr_abs_from_spectra(cfg, spectra, fast)
        ptr, delay_idx, peak, found, first = sync.first_lock(cfg, corr)
        at = first[..., None, None].expand(*first.shape, 1, spectra.shape[-1])
        spec1 = spectra.gather(-2, at)[..., 0, :]
    elif fast in ("conv", "kernel"):
        peaks = (sync_search.sync_peaks(cfg, x, n_trials) if fast == "kernel"
                 else fast_sync.sync_corr_abs_fast(cfg, x, n_trials).max(-1))
        ptr, delay_idx, peak, found, first = sync.lock_from_peaks(cfg, *peaks)
        spec1 = sync.sync_spectrum_at(
            cfg, x, first, method="dft" if fast == "kernel" else None)
    else:
        raise ValueError(f"unknown sync path {fast!r}")
    _, chan_full, cir = sync.estimate_channel(cfg, spec1, delay_idx)
    if perfect_chan_est and genie_h is not None:
        # the true channel in the estimator's timing frame: rotated by the
        # winning delay as the estimate is
        bins = sync._bins_on(x.device, cfg.nfft, cfg.num_synch_bins)
        hf = torch.fft.fft(torch.as_tensor(np.asarray(genie_h, np.complex64),
                                           device=x.device), cfg.nfft)
        rot = torch.exp((1j * 2.0 * np.pi / cfg.nfft) *
                        delay_idx.to(torch.float32)[..., None] *
                        torch.arange(cfg.nfft, dtype=torch.float32,
                                     device=x.device))
        chan_full = torch.zeros_like(chan_full)
        chan_full[..., bins] = (hf * rot)[..., bins]
        cir = torch.fft.ifft(chan_full, cfg.nfft, dim=-1)
    if cfg.pilot_grid != "none":
        phasors, h_data = pilots.equalize_data_symbols_pilot(
            cfg, x, ptr, delay_idx, num_patterns, return_chan=True, eq=eq)
    else:
        equalise = (equalize.equalize_data_symbols if eq == "kernel"
                    else sync.equalize_data_symbols)
        phasors = equalise(cfg, x, ptr, delay_idx, chan_full, num_patterns)
        h_data = chan_full[..., sync._bins_on(x.device, cfg.nfft,
                                              cfg.num_data_bins)]
    phasors, hard, llr0, llr1 = demap(cfg, phasors, h_data)
    return RxResult(phasors, hard, llr0, llr1, ptr, delay_idx, peak, found,
                    cir)


def rx_frames_batch(cfg: OFDMConfig, xs: torch.Tensor, n_trials: int,
                    num_patterns: int, plain: bool = False) -> BatchRxResult:
    """Whole-batch RX (``rxofdm.rx_frames_batch``): xs [B, n].  One K4
    launch searches every frame and gives each trial's peak and delay (its
    peaks form); the data demod runs as one K2 launch over
    the flattened [B*K, nfft] windows with per-row coefficients (with a
    pilot grid: the rotation alone, then the pilot estimate and the MMSE
    gain in torch); the demap is ``rx_frame``'s, per frame.  ``plain`` runs
    the kernels' plain versions instead (what the kernels are held to on
    the card), the pilot equaliser through ``torch.fft``.  Spans
    ``ofdm.search``, ``ofdm.lock``, ``ofdm.demod``, ``ofdm.demap``."""
    search = (sync_search.sync_peaks_plain if plain
              else sync_search.sync_peaks)
    with profiling.span("ofdm.search"):
        peak, delay = search(cfg, xs, n_trials)          # [B, p] each
    with profiling.span("ofdm.lock"):
        ptr, delay_idx, _, found, first = sync.lock_from_peaks(cfg, peak,
                                                               delay)
    with profiling.span("ofdm.demod"):
        if cfg.pilot_grid != "none":
            ph, h_data = pilots.equalize_data_symbols_pilot(
                cfg, xs, ptr, delay_idx, num_patterns, return_chan=True,
                eq=None if plain else "kernel")
        else:
            spec1 = sync.sync_spectrum_at(cfg, xs, first, method="dft")
            _, chan_full, _ = sync.estimate_channel(cfg, spec1, delay_idx)
            win = equalize.data_windows(cfg, xs, ptr,
                                        num_patterns)    # [B, K, nfft]
            coeff = equalize.combined_coeff(cfg, delay_idx,
                                            chan_full)   # [B, nb]
            ph = equalize.demod_frames(
                cfg, win, coeff, equalize.demod_windows_plain if plain
                else equalize.demod_windows)
            h_data = chan_full[..., sync._bins_on(xs.device, cfg.nfft,
                                                  cfg.num_data_bins)]
    with profiling.span("ofdm.demap"):
        ph, hard, _, _ = demap(cfg, ph, h_data)
    return BatchRxResult(hard, found, ptr, delay_idx, ph)


def plan_rx(cfg: OFDMConfig, n_samples: int) -> tuple[int, int]:
    """Static (n_trials, num_patterns) for a buffer length
    (``rxofdm.plan_rx``)."""
    n_trials = sync.n_trials_for(cfg, n_samples)
    block = cfg.pattern_len * cfg.rx_b_len
    avail = (n_samples - cfg.cp_len - (cfg.pattern_len - 1) * cfg.rx_b_len -
             cfg.nfft)
    num_patterns = max(0, min(cfg.num_patterns, avail // block + 1))
    return n_trials, num_patterns


def make_rx(cfg: OFDMConfig, n_samples: int, **kwargs):
    """rx_frame bound to a buffer length; kwargs forward to rx_frame."""
    n_trials, num_patterns = plan_rx(cfg, n_samples)
    return functools.partial(rx_frame, cfg, n_trials=n_trials,
                             num_patterns=num_patterns, **kwargs)
