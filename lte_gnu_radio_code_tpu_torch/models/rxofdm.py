"""RX model in torch: sync search -> first lock -> channel estimate ->
data demod -> QPSK LLR.

Port of ``lte_gnu_radio_code_tpu/models/rxofdm.py`` (``rx_frame``,
``rx_frames_batch``, ``plan_rx``, ``make_rx``).  Pilot grids and QAM
demapping are not ported yet and raise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import equalize, sync_search
from ..ops import fast_sync, modulation, sync
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


def _require_qpsk_no_pilots(cfg: OFDMConfig):
    if cfg.pilot_grid != "none":
        raise NotImplementedError("pilot grids are not ported yet")
    if cfg.modulation != "QPSK":
        raise NotImplementedError(
            f"{cfg.modulation} demapping is not ported yet (QPSK only)")


def rx_frame(cfg: OFDMConfig, x: torch.Tensor, n_trials: int,
             num_patterns: int, fast: str | None = None, genie_h=None,
             perfect_chan_est: bool = False,
             eq: str | None = None) -> RxResult:
    """Demodulate one buffer x [n] (``rxofdm.rx_frame``).

    ``fast`` selects the delay search: None / "ifft" (trial FFTs + one
    inverse FFT per trial), "exact" (the dense delay matmul), "conv" (the
    conv-bank, ``ops.fast_sync``) or "kernel" (K4).  ``eq`` None runs the
    FFT equaliser, "kernel" K2.  ``perfect_chan_est`` substitutes the true
    channel ``genie_h`` (a CIR) for the estimate."""
    _require_qpsk_no_pilots(cfg)
    fast = fast or "ifft"
    if fast in ("ifft", "exact"):
        spectra = sync.sync_spectra(cfg, x, n_trials)
        corr = sync.corr_abs_from_spectra(cfg, spectra, fast)
        ptr, delay_idx, peak, found, first = sync.first_lock(cfg, corr)
        _, chan_full, cir = sync.estimate_channel(cfg, spectra[first],
                                                  delay_idx)
    elif fast in ("conv", "kernel"):
        search = (sync_search.sync_corr_abs if fast == "kernel"
                  else fast_sync.sync_corr_abs_fast)
        corr = search(cfg, x, n_trials)
        ptr, delay_idx, peak, found, first = sync.first_lock(cfg, corr)
        spec1 = sync.sync_spectrum_at(
            cfg, x, first, method="dft" if fast == "kernel" else None)
        _, chan_full, cir = sync.estimate_channel(cfg, spec1, delay_idx)
    else:
        raise ValueError(f"unknown sync path {fast!r}")
    if perfect_chan_est and genie_h is not None:
        # the true channel in the estimator's timing frame: rotated by the
        # winning delay as the estimate is
        bins = sync._bins_on(x.device, cfg.nfft, cfg.num_synch_bins)
        hf = torch.fft.fft(torch.as_tensor(np.asarray(genie_h, np.complex64),
                                           device=x.device), cfg.nfft)
        rot = torch.exp((1j * 2.0 * np.pi / cfg.nfft) *
                        delay_idx.to(torch.float32) *
                        torch.arange(cfg.nfft, dtype=torch.float32,
                                     device=x.device))
        chan_full = torch.zeros(cfg.nfft, dtype=torch.complex64,
                                device=x.device)
        chan_full[bins] = (hf * rot)[bins]
        cir = torch.fft.ifft(chan_full, cfg.nfft)
    if eq == "kernel":
        phasors = equalize.equalize_data_symbols(
            cfg, x, ptr, delay_idx, chan_full, num_patterns)
    elif eq is None:
        phasors = sync.equalize_data_symbols(
            cfg, x, ptr, delay_idx, chan_full, num_patterns)
    else:
        raise ValueError(f"unknown equaliser path {eq!r}")
    hard, llr0, llr1 = modulation.qpsk_llr(phasors)
    return RxResult(phasors, hard, llr0, llr1, ptr, delay_idx, peak, found,
                    cir)


def rx_frames_batch(cfg: OFDMConfig, xs: torch.Tensor, n_trials: int,
                    num_patterns: int, plain: bool = False) -> BatchRxResult:
    """Whole-batch RX (``rxofdm.rx_frames_batch``): xs [B, n].  One K4
    launch searches every frame; the data demod runs as one K2 launch over
    the flattened [B*K, nfft] windows with per-row coefficients; the LLR
    demap's sigma stays per frame.  ``plain`` runs the kernels' plain twins
    instead (the reference the kernels are held to on the card)."""
    _require_qpsk_no_pilots(cfg)
    search = (sync_search.sync_corr_abs_plain if plain
              else sync_search.sync_corr_abs)
    demod = equalize.demod_windows_plain if plain else equalize.demod_windows
    b = xs.shape[0]
    corr = search(cfg, xs, n_trials)                     # [B, p, D]
    ptr, delay_idx, _, found, first = sync.first_lock(cfg, corr)
    spec1 = sync.sync_spectrum_at(cfg, xs, first, method="dft")
    _, chan_full, _ = sync.estimate_channel(cfg, spec1, delay_idx)
    win = equalize.data_windows(cfg, xs, ptr, num_patterns)  # [B, K, nfft]
    coeff = equalize.combined_coeff(cfg, delay_idx, chan_full)  # [B, nb]
    k = win.shape[1]
    coeff_rows = coeff[:, None, :].expand(b, k, coeff.shape[-1])
    # with one frame the reshape of the expanded view copies nothing and
    # stays strided: K2 takes contiguous rows
    ph = demod(cfg, win.reshape(b * k, cfg.nfft),
               coeff_rows.reshape(b * k, -1).contiguous())
    hard, _, _ = modulation.qpsk_llr_frames(ph.reshape(b, k, -1))
    return BatchRxResult(hard, found, ptr, delay_idx)


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
