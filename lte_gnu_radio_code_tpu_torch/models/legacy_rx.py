"""The legacy receivers in torch: multi-detection sync with a CFO
hypothesis search and DSSS despreading.

Port of ``lte_gnu_radio_code_tpu/models/legacy_rx.py`` (``LegacyRxResult``,
``rx_frame_cfo``, ``make_legacy_rx``).  The (trial, fo, delay) search is
plain torch, one candidate at a time (``ops/cfo.py``); detections are
selected by the refractory rule; the channel estimates, the one data symbol
that follows each detection and the despread run over the whole fixed-size
detection table at once, with a ``valid`` mask and no host sync.  The data
path uses each detection's own winning CFO candidate, as the JAX package
does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..kernels import equalize
from ..ops import cfo as cfo_ops
from ..ops import sync
from ..utils.device import as_samples, resolve_device
from ..utils.params import OFDMConfig
from . import stream_rx


class LegacyRxResult(NamedTuple):
    ptrs: torch.Tensor         # [max_det] detection frame pointers
    delays: torch.Tensor       # [max_det] winning delay hypotheses
    peaks: torch.Tensor        # [max_det] correlation peaks
    fo_idx: torch.Tensor       # [max_det] winning CFO candidate index
    count: torch.Tensor        # number of detections
    chan_freq: torch.Tensor    # [max_det, nfft] channel estimates
    phasors: torch.Tensor      # [max_det, num_data_bins] equalised data
    despread: torch.Tensor     # [max_det, num_data_bins/dsss]


def demod_after_detections(cfg: OFDMConfig, x: torch.Tensor,
                           start: torch.Tensor, ok: torch.Tensor,
                           delays: torch.Tensor, fo_sel: torch.Tensor,
                           chans: torch.Tensor,
                           bank: torch.Tensor) -> torch.Tensor:
    """The one data symbol of each detection: the window at ``start``
    [..., D] (0 where not ``ok``) re-mixed by the detection's winning CFO
    candidate, then the power-normalised data-bin spectrum times rot * MMSE
    gain * ok.  That is K2 with one coefficient row a window: the windows
    are mixed first and ``ok`` is folded into the row
    (``stream_rx.demod_rows``).  Returns phasors [..., D, B]."""
    rel = torch.arange(cfg.nfft, device=x.device)
    win = sync.windows_at(x, start, rel) * cfo_ops.bank_select(bank, fo_sel)
    coeff = equalize.combined_coeff(cfg, delays, chans) * ok[..., None]
    return stream_rx.demod_rows(cfg, win, coeff)


def rx_frame_cfo(cfg: OFDMConfig, x: torch.Tensor, n_trials: int,
                 fo_range=(0.0,), dsss: int = 1,
                 max_det: int = 100) -> LegacyRxResult:
    """Multi-detection CFO-search RX over a sample buffer x [..., n]
    (``legacy_rx.py:rx_frame_cfo``); the data demod is one K2 call over
    the detection table."""
    bank = cfo_ops.bank_on(cfg, fo_range, x.device)
    dmax_val, delay_win, fo_win = cfo_ops.cfo_search_scan(
        cfg, x, n_trials, bank)
    ptrs, (delays, fo_sel, peaks), count = sync.refractory_detect(
        cfg, dmax_val, (delay_win, fo_win, dmax_val), max_det)
    valid = torch.arange(max_det, device=x.device) < count[..., None]

    # channel estimate of each detection from its own re-mixed spectrum
    det_spec = cfo_ops.spectra_at_detections(
        cfg, x, torch.where(valid, ptrs, 0), fo_sel, bank)
    _, chan_full, _ = sync.estimate_channel(cfg, det_spec,
                                            delays.to(torch.int64))
    chan_full = chan_full * valid[..., None]

    start = ptrs + cfg.m_synch * cfg.rx_b_len
    ok = valid & (start + cfg.nfft - 1 < x.shape[-1])
    phasors = demod_after_detections(
        cfg, x, torch.where(ok, start, 0), ok, delays, fo_sel, chan_full,
        bank)
    return LegacyRxResult(ptrs, delays, peaks, fo_sel, count, chan_full,
                          phasors, cfo_ops.dsss_despread(phasors, dsss))


def make_legacy_rx(cfg: OFDMConfig, n_samples: int, fo_range=(0.0,),
                   dsss: int = 1, max_det: int = 100, device=None):
    """rx_frame_cfo bound to a buffer length (``legacy_rx.py:make_legacy_rx``).
    The returned function takes the samples (a tensor or anything numpy
    takes) to the CUDA device, or to ``device``."""
    device = resolve_device(device)
    fn = functools.partial(
        rx_frame_cfo, cfg, n_trials=sync.n_trials_for(cfg, n_samples),
        fo_range=tuple(fo_range), dsss=dsss, max_det=max_det)
    return lambda x: fn(as_samples(x, device))
