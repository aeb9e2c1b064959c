"""Synchronisation, channel estimation and MMSE equalisation in torch.

Port of ``lte_gnu_radio_code_tpu/ops/sync.py``: ``n_trials_for``,
``sync_spectrum_at`` (its "dft" form),
``sync_correlate_ifft``, ``lock_from_peaks`` (``first_lock`` after its
per-trial reduction, which K4's peaks form makes), ``estimate_channel``,
``mmse_gain``, ``demap_unbias_gain``, the timing :func:`derotation`, and
the refractory (multi-detection) selection:
``refractory_scan``, ``emit_slots``, ``refractory_select_idx``,
``refractory_table`` and ``refractory_detect``.  Functions that take a lock
or a table of detections take leading frame dimensions: x [..., n] with
one lock, or [..., D] detections, per frame.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import _cuda
from ..utils.params import OFDMConfig, used_bins
from ..utils.tables import device_table
from .zadoff_chu import delay_search_matrix, zc_for_config


def n_trials_for(cfg: OFDMConfig, n_samples: int) -> int:
    """Stride-spaced sync trials that fit in an n_samples buffer."""
    need = cfg.m_synch * cfg.rx_b_len + cfg.nfft + cfg.cp_len
    return max(0, (n_samples - need - 1) // cfg.stride + 1)


def _bins(nfft: int, num_bins: int) -> np.ndarray:
    return np.asarray(used_bins(nfft, num_bins)[1], np.int64)


def _bins_on(device, nfft: int, num_bins: int) -> torch.Tensor:
    """Wrapped FFT indices of the used bins, as a tensor on device."""
    return device_table(_bins, device, nfft, num_bins)


def windows_at(x: torch.Tensor, start, rel: torch.Tensor) -> torch.Tensor:
    """x[..., start + rel] for x [..., n] and an int64 offset table rel [*s]
    on x's device.  start holds one start per frame ([...], or a scalar for
    every frame: result [..., *s]) or a table of starts per frame
    ([..., *d]: result [..., *d, *s]).  As the JAX package's edge-padded
    ``dynamic_slice``: start clamps to [0, n] and indices past the end read the
    last sample."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    st = torch.as_tensor(start, device=x.device).to(torch.int64)
    if st.ndim < len(lead):
        st = st.expand(lead)
    per = st.shape[len(lead):]                    # starts of one frame
    st = st.clamp(0, n).reshape(*st.shape, *([1] * rel.ndim))
    idx = (st + rel).clamp_max(n - 1)
    return torch.gather(x, -1, idx.reshape(*lead, -1)).reshape(
        *lead, *per, *rel.shape)


@functools.lru_cache(maxsize=32)
def _dft_synch_bins(nfft: int, num_bins: int) -> np.ndarray:
    """[nfft, L] DFT basis on the synch bins (``sync._dft_synch_bins``)."""
    n = np.arange(nfft)
    return np.exp(-2j * np.pi * np.outer(n, _bins(nfft, num_bins)) / nfft
                  ).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _synch_window_offsets(cfg: OFDMConfig) -> np.ndarray:
    """[m_synch, nfft] offsets of a trial's CP-skipped synch windows."""
    return ((np.arange(cfg.m_synch) * cfg.rx_b_len)[:, None] +
            np.arange(cfg.nfft)[None, :])


def sync_spectrum_at(cfg: OFDMConfig, x: torch.Tensor,
                     trial) -> torch.Tensor:
    """Power-normalised synch-bin spectrum at one trial per frame: x
    [..., n], trial [...] -> [..., m_synch*num_synch_bins]
    (``sync.py:sync_spectrum_at`` with method "dft": a product with the
    synch-bin DFT basis)."""
    return sync_spectrum_at_ptr(
        cfg, x, cfg.cp_len + cfg.stride *
        torch.as_tensor(trial, device=x.device))


def sync_spectrum_at_ptr(cfg: OFDMConfig, x: torch.Tensor,
                         ptr) -> torch.Tensor:
    """:func:`sync_spectrum_at` at sample pointers instead of trial
    indices: ptr [...] (one per frame) or [..., D] (a detection table per
    frame) -> [..., m_synch*num_synch_bins] or [..., D, that]."""
    _cuda.require_fp32(x.device)
    win = windows_at(x, ptr,
                     device_table(_synch_window_offsets, x.device, cfg))
    s = win @ device_table(_dft_synch_bins, x.device, cfg.nfft,
                           cfg.num_synch_bins)
    s = s.reshape(*s.shape[:-2], -1)
    power = (s.abs() ** 2).sum(-1, keepdim=True)
    return s * torch.sqrt(s.shape[-1] / power.clamp_min(1e-30))


def sync_correlate_ifft(cfg: OFDMConfig,
                        spectra: torch.Tensor) -> torch.Tensor:
    """The same correlation as one inverse FFT per trial
    (``sync.py:sync_correlate_ifft``)."""
    zc = device_table(zc_for_config, spectra.device, cfg)
    lead = spectra.shape[:-1]
    q = (spectra * zc.conj()).reshape(*lead, cfg.m_synch,
                                      cfg.num_synch_bins).sum(-2)
    y = spectra.new_zeros(*lead, cfg.nfft)
    y[..., _bins_on(y.device, cfg.nfft, cfg.num_synch_bins)] = q
    return cfg.nfft * torch.fft.ifft(y, dim=-1)[..., : cfg.cp_len + 1]


def gate_level(cfg: OFDMConfig) -> float:
    """The detection gate on a trial's peak.  Compared with a float32
    tensor, the Python float is rounded to float32, as JAX rounds its
    weakly typed scalar."""
    return cfg.detection_gate * cfg.m_synch * cfg.num_synch_bins


def lock_from_peaks(cfg: OFDMConfig, peak: torch.Tensor,
                    delay: torch.Tensor):
    """First trial whose peak crosses the gate, per frame, from each
    trial's peak and delay (peak, delay [..., p], e.g. from
    ``kernels/sync_search.py:sync_peaks``) -> (ptr, delay_idx, peak, found,
    first), each [...] (``sync.py:first_lock`` after its per-trial
    reduction).  No crossing gives trial 0, as jnp.argmax."""
    mask = peak > gate_level(cfg)
    found = mask.any(-1)
    first = mask.to(torch.int32).argmax(-1)       # argmax rejects bool
    ptr = cfg.cp_len + cfg.stride * first
    at = first[..., None]
    return (ptr, delay.gather(-1, at)[..., 0], peak.gather(-1, at)[..., 0],
            found, first)


def scalar_like(v, ref: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """v as a tensor of dtype on ref's device.  A Python scalar becomes a
    filled tensor (a device-side fill, no copy from the host, so a step that
    calls this stays capturable in a CUDA graph)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=ref.device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=ref.device)


def refractory_scan(cfg: OFDMConfig, crossing: torch.Tensor,
                    ptrs: torch.Tensor, last_ptr=None, any_yet=None):
    """The sequential detection rule, trial by trial, with an explicit
    initial carry (``sync.py:refractory_scan``): accept a crossing iff
    ptr - last_accepted_ptr > 2*cp + nfft, or nothing was accepted yet.
    crossing [..., p], ptrs [p] or [..., p]; returns (accepted [..., p]
    bool, (last_ptr, any_yet) final carry, each [...]).  A Python loop over
    the trials: the oracle that :func:`refractory_select_idx` is held to,
    not a path of the receivers."""
    refractory = 2 * cfg.cp_len + cfg.nfft
    lead = crossing.shape[:-1]
    lp = scalar_like(0 if last_ptr is None else last_ptr, crossing,
                     torch.int64).expand(lead)
    ay = scalar_like(False if any_yet is None else any_yet, crossing,
                     torch.bool).expand(lead)
    ptrs = ptrs.to(torch.int64).expand(crossing.shape)
    accepted = []
    for i in range(crossing.shape[-1]):
        ok = crossing[..., i] & ((ptrs[..., i] - lp > refractory) | ~ay)
        lp = torch.where(ok, ptrs[..., i], lp)
        ay = ay | ok
        accepted.append(ok)
    accepted = (torch.stack(accepted, -1) if accepted
                else torch.zeros_like(crossing))
    return accepted, (lp.to(torch.int32), ay)


def emit_slots(accepted: torch.Tensor, sources: tuple, max_det: int):
    """Scatter the accepted trials into a fixed [..., max_det] detection
    table (``sync.py:emit_slots``).  sources: [p] or [..., p] tensors.
    Returns (outs tuple of [..., max_det], count [...] int32); detections
    beyond max_det are dropped, empty slots are zero."""
    acc = accepted.to(torch.int64)
    slot = acc.cumsum(-1) - 1
    count = acc.sum(-1).clamp_max(max_det).to(torch.int32)
    # one spare slot past the table takes every trial that is not emitted
    tgt = torch.where(accepted & (slot < max_det), slot, max_det)

    def emit(src):
        out = src.new_zeros(*accepted.shape[:-1], max_det + 1)
        return out.scatter(-1, tgt, src.expand(accepted.shape))[..., :max_det]

    return tuple(emit(s) for s in sources), count


def refractory_select_idx(cfg: OFDMConfig, crossing: torch.Tensor,
                          max_det: int, idx_start):
    """The sequential refractory acceptance, exactly, without a loop over
    trials or detections (``sync.py:refractory_select_idx``).

    With nxt[i] the first crossing at or after trial i (a reversed cummin),
    the accepted trials are the orbit of a_0 = nxt[idx_start] under
    g(a) = nxt[a + jump], jump = refractory // stride + 1: each acceptance
    moves the cursor past its refractory window.  The JAX package walks the
    orbit in a scan of max_det data-dependent steps; here g is composed
    with itself: once the orbit's first 2^k members and g^(2^k) are known,
    one gather gives the next 2^k members and one more squares the map, so
    ceil(log2(max_det)) rounds list the first max_det members, in order.
    Needs trial pointers affine in the trial index (ptr = base + stride*i,
    true of every caller); the first acceptance has i >= idx_start [...].

    crossing [..., p] -> (idxs [..., max_det] int64, the accepted trial
    indices in order, zero in empty slots; oks [..., max_det] bool)."""
    p = crossing.shape[-1]
    jump = (2 * cfg.cp_len + cfg.nfft) // max(1, cfg.stride) + 1
    ar = torch.arange(p + 1, device=crossing.device)
    # index p stands for "no crossing": nxt[p] = p, so the orbit ends there
    cand = torch.where(torch.nn.functional.pad(crossing, (0, 1)), ar, p)
    nxt = cand.flip(-1).cummin(-1).values.flip(-1)              # [..., p+1]
    start = scalar_like(idx_start, crossing, torch.int64).clamp(
        0, p).expand(crossing.shape[:-1])
    members = nxt.gather(-1, start[..., None])                  # a_0
    step = nxt[..., (ar + jump).clamp_max(p)]                   # g, [..., p+1]
    rounds = (max_det - 1).bit_length()
    for k in range(rounds):
        # members holds the orbit's first 2^k, step is g^(2^k)
        members = torch.cat([members, step.gather(-1, members)], -1)
        if k + 1 < rounds:
            step = step.gather(-1, step)
    members = members[..., :max_det]
    oks = members < p
    return torch.where(oks, members, 0), oks


def refractory_table(cfg: OFDMConfig, crossing: torch.Tensor, extras: tuple,
                     max_det: int, base_ptr, last_ptr=None, any_yet=None):
    """Drop-in for :func:`refractory_scan` + :func:`emit_slots` over affine
    trial pointers ptr_i = base_ptr + stride*i (``sync.py:refractory_table``).
    crossing [..., p], extras [p] or [..., p] each, base_ptr / last_ptr /
    any_yet scalars or [...].  Returns (ptrs [..., max_det] int32, -1 in
    empty slots; extras_out tuple of [..., max_det]; count [...] int32;
    (last_ptr int32, any_yet) final carry).

    Where a chunk holds more than max_det acceptances the selection stops at
    the max_det-th, and so does the returned carry, while the sequential
    scan's carry moves on.  A caller that continues the carry therefore
    sizes max_det >= trial span // refractory + 1 (what
    ``runtime.stream.reacq_det_max`` computes), which rules overflow out;
    this raises when a carry is passed with a smaller table.  Callers
    without a carry (:func:`refractory_detect`) keep the drop-overflow
    table."""
    stride = max(1, cfg.stride)
    refractory = 2 * cfg.cp_len + cfg.nfft
    if last_ptr is not None or any_yet is not None:
        span = crossing.shape[-1] * stride
        if max_det < span // refractory + 1:
            raise ValueError(
                f"refractory_table: max_det={max_det} can overflow ({span} "
                f"trial-span samples / refractory {refractory}); size it "
                "with runtime.stream.reacq_det_max")
    last = scalar_like(0 if last_ptr is None else last_ptr, crossing,
                       torch.int64)
    any_ = scalar_like(False if any_yet is None else any_yet, crossing,
                       torch.bool)
    base = scalar_like(base_ptr, crossing, torch.int64)
    # floored like the JAX package's //: negative on a stream's first chunks
    idx_start = torch.where(
        any_, torch.div(last + refractory - base, stride,
                        rounding_mode="floor") + 1, 0)
    idxs, oks = refractory_select_idx(cfg, crossing, max_det, idx_start)
    ptrs = torch.where(oks, base[..., None] + stride * idxs, -1)
    outs = tuple(torch.where(oks, e.expand(crossing.shape).gather(-1, idxs),
                             0) for e in extras)
    count = oks.sum(-1)
    last_idx = torch.where(oks, idxs, -1).amax(-1)
    new_last = torch.where(count > 0, base + stride * last_idx, last)
    return (ptrs.to(torch.int32), outs, count.to(torch.int32),
            (new_last.to(torch.int32), any_ | (count > 0)))


def refractory_detect(cfg: OFDMConfig, dmax_val: torch.Tensor,
                      extras: tuple, max_det: int):
    """Gate + refractory selection over per-trial peaks dmax_val [..., p]
    (``sync.py:refractory_detect``): (ptrs [..., max_det] int32, zero in
    empty slots; extras_out; count)."""
    ptrs, outs, count, _ = refractory_table(
        cfg, dmax_val > gate_level(cfg), tuple(extras), max_det, cfg.cp_len)
    return ptrs.clamp_min(0), outs, count


def estimate_channel(cfg: OFDMConfig, spectrum: torch.Tensor, delay_idx):
    """ZC-correlation channel estimate from the lock spectrum, per frame:
    spectrum [..., m_synch*L], delay_idx [...] -> (chan_est [..., L],
    chan_full [..., nfft], cir [..., nfft]) (``sync.py:estimate_channel``)."""
    dev = spectrum.device
    zc = device_table(zc_for_config, dev, cfg)
    dse = device_table(delay_search_matrix, dev, cfg)
    # index_select, not dse[delay]: indexing with a 0-dim tensor would wait
    # for the device to read the index on the host
    delay = torch.as_tensor(delay_idx, device=dev)
    data_recov = dse.index_select(0, delay.reshape(-1)).reshape(
        *delay.shape, -1) * spectrum
    tmp = (data_recov * zc.conj()) / (1.0 / cfg.snr_linear + 1.0)
    lead = spectrum.shape[:-1]
    chan_est = tmp.reshape(*lead, cfg.m_synch, cfg.num_synch_bins).mean(-2)
    full = spectrum.new_zeros(*lead, cfg.nfft)
    full[..., _bins_on(dev, cfg.nfft, cfg.num_synch_bins)] = chan_est
    return chan_est, full, torch.fft.ifft(full, cfg.nfft, dim=-1)


def mmse_gain(chan: torch.Tensor, snr_lin: float) -> torch.Tensor:
    """One-tap MMSE gain conj(H) / (|H|^2 + 1/SNR)."""
    return chan.conj() / (1.0 / snr_lin + chan.abs() ** 2)


def derotation(nfft: int, delay, bins: torch.Tensor) -> torch.Tensor:
    """[..., K] timing derotation e^{+j 2 pi d b / N} of each delay d
    [...] on the bins b [K] (a tensor on the device the result is on)."""
    d = torch.as_tensor(delay, device=bins.device).to(torch.float32)
    return torch.exp((1j * 2.0 * np.pi / nfft) * d[..., None] *
                     bins.to(torch.float32))


def demap_unbias_gain(chan: torch.Tensor, snr_lin: float) -> torch.Tensor:
    """Per-bin real gain (|H|^2 + 1/SNR) / |H|^2 that removes the MMSE
    equaliser's amplitude bias before a QAM demap
    (``sync.py:demap_unbias_gain``)."""
    h2 = chan.abs() ** 2
    return (h2 + 1.0 / snr_lin) / h2.clamp_min(1e-30)


@functools.lru_cache(maxsize=16)
def data_window_offsets(cfg: OFDMConfig, num_patterns: int) -> np.ndarray:
    """[num_patterns*nd, nfft] offsets of the data-symbol windows from the
    lock pointer."""
    m0, nd = cfg.m_synch, cfg.synch_dat[1]
    block = cfg.pattern_len * cfg.rx_b_len
    return (np.arange(num_patterns)[:, None, None] * block +
            (m0 + np.arange(nd))[None, :, None] * cfg.rx_b_len +
            np.arange(cfg.nfft)[None, None, :]).reshape(-1, cfg.nfft)
