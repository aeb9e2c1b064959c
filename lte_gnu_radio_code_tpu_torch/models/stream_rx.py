"""Multi-detection RX in torch: the continuous gr-RXOFDM semantics, batched.

Port of ``lte_gnu_radio_code_tpu/models/stream_rx.py`` (``DetectionsOut``,
``hard_decide``, ``detect_trials``, ``demod_detections``, ``rx_detections``,
``make_rx_detections``).  Where the single-lock path (``models/rxofdm.py``)
locks once, this receiver accepts every un-refractory gate crossing,
refreshes the channel estimate per detection and demodulates each
detection's pattern block with its own estimate, so it follows timing drift
and channel changes over a replayed stream.

Every function takes leading stream dimensions (x [..., n], one detection
table [..., max_det] per stream) and keeps static shapes with a ``valid``
mask: nothing is compacted on the device and nothing waits for the host.
The sync search is one K4 call over all streams and the per-detection
demod one K2 call over the flattened [streams*max_det*nd, nfft] windows
with one coefficient row per window; on the CPU each is its plain twin.
Hard bits are the reference's per-rail decision for QPSK and the max-log
decision, on phasors with the MMSE amplitude bias taken out, for any other
modulation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..kernels import equalize, sync_search
from ..ops import modulation, sync
from ..utils.params import OFDMConfig
from ..utils.tables import device_table


class DetectionsOut(NamedTuple):
    ptrs: torch.Tensor       # [max_det] i32 sample pointer per detection
    delays: torch.Tensor     # [max_det] i32 winning delay hypothesis
    peaks: torch.Tensor      # [max_det] f32 correlation peak
    count: torch.Tensor      # scalar i32: number of valid detections
    valid: torch.Tensor      # [max_det] bool: slot holds a detection
    demod_ok: torch.Tensor   # [max_det] bool: data window fit in the buffer
    chans: torch.Tensor      # [max_det, nfft] c64 per-detection channel
    phasors: torch.Tensor    # [max_det, nd, num_data_bins] equalised IQ
    hard_bits: torch.Tensor  # [max_det, nd, num_data_bins*bits_per_bin] i32


_HALF_SQRT2 = 0.7071067811865476


def hard_decide(cfg: OFDMConfig, phasors: torch.Tensor) -> torch.Tensor:
    """Hard bits, shape-preserving and sigma-free
    (``stream_rx.py:hard_decide``): [..., B] phasors -> [...,
    B*bits_per_bin] int32.  Any modulation but QPSK: the max-log decision
    (``modulation.maxlog_llr`` at noise variance 1.0, which scales the LLRs
    and moves no sign).  QPSK: the reference's bits per rail, even index
    the real rail, odd the imaginary.  The LLR demap's sign test
    reduces to comparing er = ||comp| - K| with K = sqrt(2)/2, the rail
    amplitude (the noise scale cancels), so the bits do not depend on the
    batch they were demapped in.  Keeps the reference's quirk: a component
    that overshoots its point by more than K (|comp| > sqrt(2)) flips the
    bit.  Both comparisons are float32 ones, as in the JAX package."""
    if cfg.modulation != "QPSK":
        hard, _ = modulation.maxlog_llr(phasors, cfg.modulation, 1.0)
        return hard.reshape(*phasors.shape[:-1], -1)

    def rail(comp):
        er = (comp.abs() - _HALF_SQRT2).abs()
        return torch.where(comp >= 0, er > _HALF_SQRT2,
                           er < _HALF_SQRT2).to(torch.int32)

    return torch.stack([rail(phasors.real), rail(phasors.imag)], -1).reshape(
        *phasors.shape[:-1], -1)


def detect_trials(cfg: OFDMConfig, x: torch.Tensor, n_trials: int):
    """Per-trial (peak, delay) over the sync search of x [..., n]
    (``stream_rx.py:detect_trials``): (dmax_val [..., p] f32, dmax_ind
    [..., p] i32), K4 in its peaks form, one launch for every stream, the
    reduction inside it.  Ties go to the first delay, as jnp.argmax."""
    return sync_search.sync_peaks(cfg, x, n_trials)


def detection_rows(cfg: OFDMConfig, ext: torch.Tensor,
                   ptrs_rel: torch.Tensor, delays: torch.Tensor,
                   valid: torch.Tensor, n_readable):
    """What the demod of a detection table needs, gathered at the
    detections' pointers: the channel estimate of each detection from its
    own synch spectrum (``sync.sync_spectrum_at_ptr``), whether
    its data windows lie inside the n_readable real samples, the windows,
    and one coefficient row per detection in which the derotation, the MMSE
    gain and the demod_ok mask are folded.  Empty slots sit at pointer 0
    with a zero coefficient.

    Returns (chans [..., max_det, nfft], demod_ok [..., max_det], dwin
    [..., max_det, nd, nfft], coeff [..., max_det, B])."""
    m0, nd = cfg.m_synch, cfg.synch_dat[1]
    safe_ptr = torch.where(valid, ptrs_rel, 0).to(torch.int64)
    spec = sync.sync_spectrum_at_ptr(cfg, ext, safe_ptr)
    _, chans, _ = sync.estimate_channel(cfg, spec, delays.to(torch.int64))
    chans = chans * valid[..., None]
    n_read = sync.scalar_like(n_readable, ext, torch.int64)
    if n_read.ndim:
        n_read = n_read[..., None]
    demod_ok = valid & (safe_ptr + (m0 + nd - 1) * cfg.rx_b_len + cfg.nfft
                        <= n_read)
    # [nd, nfft] offsets of one pattern block's data windows
    dwin = sync.windows_at(ext, safe_ptr, device_table(
        sync.data_window_offsets, ext.device, cfg, 1))
    coeff = equalize.combined_coeff(cfg, delays, chans) * demod_ok[..., None]
    return chans, demod_ok, dwin, coeff


def demod_rows(cfg: OFDMConfig, win: torch.Tensor,
               coeff: torch.Tensor) -> torch.Tensor:
    """Power-normalised data-bin spectra of the windows win [..., nfft]
    times coeff, one row [B] for every window or one row per window
    [..., B]: -> [..., B], from K2: one launch over the flattened,
    contiguous [rows, nfft] windows."""
    nfft, nb = cfg.nfft, cfg.num_data_bins
    if coeff.ndim > 1:
        coeff = coeff.expand(*win.shape[:-1], nb).reshape(-1, nb)
    return equalize.demod_windows(
        cfg, win.reshape(-1, nfft), coeff.contiguous()).reshape(
            *win.shape[:-1], nb)


def demod_detections(cfg: OFDMConfig, ext: torch.Tensor,
                     ptrs_rel: torch.Tensor, delays: torch.Tensor,
                     valid: torch.Tensor, n_readable):
    """Per-detection channel estimate + pattern-block demod, one batch over
    every stream and detection slot (``stream_rx.py:demod_detections``).

    ext [..., n] sample buffers; ptrs_rel, delays, valid [..., max_det]
    (pointers relative to ext[..., 0]); n_readable (scalar or [...]) the
    real samples of ext.  K2 gets [streams*max_det*nd, nfft] windows with
    one coefficient row per window.  Empty slots run too; none is skipped,
    so no count leaves the device.

    Returns (chans [..., max_det, nfft], phasors [..., max_det, nd, B],
    demod_ok [..., max_det])."""
    chans, demod_ok, dwin, coeff = detection_rows(
        cfg, ext, ptrs_rel, delays, valid, n_readable)
    phasors = demod_rows(cfg, dwin, coeff[..., None, :])
    if cfg.modulation != "QPSK":
        # the MMSE amplitude bias goes before a QAM grid decision
        bins = sync._bins_on(ext.device, cfg.nfft, cfg.num_data_bins)
        phasors = phasors * sync.demap_unbias_gain(
            chans[..., bins], cfg.snr_linear)[..., None, :]
    return chans, phasors, demod_ok


def rx_detections(cfg: OFDMConfig, x: torch.Tensor, n_trials: int,
                  max_det: int = 100) -> DetectionsOut:
    """Whole-buffer multi-detection RX of x [..., n]
    (``stream_rx.py:rx_detections``); max_det mirrors the reference's
    100-row detection table."""
    dmax_val, dmax_ind = detect_trials(cfg, x, n_trials)
    ptrs, (delays, peaks), count = sync.refractory_detect(
        cfg, dmax_val, (dmax_ind, dmax_val), max_det)
    valid = torch.arange(max_det, device=x.device) < count[..., None]
    chans, phasors, demod_ok = demod_detections(
        cfg, x, ptrs, delays, valid, x.shape[-1])
    return DetectionsOut(ptrs=ptrs, delays=delays, peaks=peaks, count=count,
                         valid=valid, demod_ok=demod_ok, chans=chans,
                         phasors=phasors,
                         hard_bits=hard_decide(cfg, phasors))


def make_rx_detections(cfg: OFDMConfig, n_samples: int,
                       max_det: int = 100):
    """rx_detections bound to a buffer length."""
    return functools.partial(rx_detections, cfg,
                             n_trials=sync.n_trials_for(cfg, n_samples),
                             max_det=max_det)
