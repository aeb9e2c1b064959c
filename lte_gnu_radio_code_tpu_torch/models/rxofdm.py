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
from ..ops import modulation, pilots, sync
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
             num_patterns: int, genie_h=None,
             perfect_chan_est: bool = False) -> RxResult:
    """Demodulate one buffer x [n], or one buffer per frame x [..., n] with
    every result carrying the leading frame axes (``rxofdm.rx_frame``, and
    ``jax.vmap`` of it).

    One K4 launch searches every frame and gives each trial's peak and
    delay (its peaks form); the lock spectrum is a product with the
    synch-bin DFT basis; the data demod is one K2 launch over every
    frame's windows with one coefficient row a frame (with a pilot grid:
    the rotation alone, then the pilot estimate and the MMSE gain in
    torch); the demap is per frame.  ``perfect_chan_est`` substitutes the
    true channel ``genie_h`` (a CIR) for the synch-symbol estimate.  Spans
    ``ofdm.search``, ``ofdm.lock``, ``ofdm.demod``, ``ofdm.demap``."""
    dev = x.device
    with profiling.span("ofdm.search"):
        peak, delay = sync_search.sync_peaks(cfg, x, n_trials)
    with profiling.span("ofdm.lock"):
        ptr, delay_idx, peak, found, first = sync.lock_from_peaks(cfg, peak,
                                                                  delay)
    with profiling.span("ofdm.demod"):
        spec1 = sync.sync_spectrum_at(cfg, x, first)
        _, chan_full, cir = sync.estimate_channel(cfg, spec1, delay_idx)
        if perfect_chan_est and genie_h is not None:
            # the true channel in the estimator's timing frame: rotated by
            # the winning delay as the estimate is
            bins = sync._bins_on(dev, cfg.nfft, cfg.num_synch_bins)
            hf = torch.fft.fft(torch.as_tensor(
                np.asarray(genie_h, np.complex64), device=dev), cfg.nfft)
            rot = sync.derotation(cfg.nfft, delay_idx, torch.arange(
                cfg.nfft, dtype=torch.float32, device=dev))
            chan_full = torch.zeros_like(chan_full)
            chan_full[..., bins] = (hf * rot)[..., bins]
            cir = torch.fft.ifft(chan_full, cfg.nfft, dim=-1)
        if cfg.pilot_grid != "none":
            phasors, h_data = pilots.equalize_data_symbols_pilot(
                cfg, x, ptr, delay_idx, num_patterns, return_chan=True)
        else:
            phasors = equalize.equalize_data_symbols(
                cfg, x, ptr, delay_idx, chan_full, num_patterns)
            h_data = chan_full[..., sync._bins_on(dev, cfg.nfft,
                                                  cfg.num_data_bins)]
    with profiling.span("ofdm.demap"):
        phasors, hard, llr0, llr1 = demap(cfg, phasors, h_data)
    return RxResult(phasors, hard, llr0, llr1, ptr, delay_idx, peak, found,
                    cir)


def rx_frames_batch(cfg: OFDMConfig, xs: torch.Tensor, n_trials: int,
                    num_patterns: int) -> BatchRxResult:
    """Whole-batch RX (``rxofdm.rx_frames_batch``): :func:`rx_frame` over
    xs [B, n], its per-frame results."""
    r = rx_frame(cfg, xs, n_trials, num_patterns)
    return BatchRxResult(r.hard_bits, r.found, r.lock_ptr, r.delay_idx,
                         r.phasors)


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
