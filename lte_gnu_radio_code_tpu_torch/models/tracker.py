"""Tracking synchroniser in torch: the reference's pointer state machine
with a least-squares drift predictor, one step per search stride.

Port of ``lte_gnu_radio_code_tpu/models/tracker.py`` (``TrackResult``,
``_masked_lstsq``, ``tracker_stride``, ``tracker_init_carry``,
``make_tracker_step``, ``demod_track_table``, ``track_frame``,
``make_tracker``).  The tracker is sequential: the window a step reads
depends on every detection before it.  The JAX package runs its step in one
``lax.scan``; here the step loop is ``kernels/tracker.py:track_scan``, one
persistent CUDA kernel on the card (one warp a stream at nfft <= 128, one
block a stream above) and a Python loop over :func:`make_tracker_step` (its
plain twin) on the CPU.  Both return the scan's step outputs and its
channel rows compacted (:func:`emit_channels`), so the detection table and
the demod after it are shared by both.

State machine (``make_tracker_step``; the carry is :class:`TrackerCarry`):

  corr_obs == -1 : search: ptr = loop*stride + (cp-5) + ptr_adj
  corr_obs <  5  : nominal advance by pattern*(nfft+cp)
  corr_obs >= 5  : ptr = ceil(b0 + b1*(sym_count*pattern) - cp/4)

with the reference's quirks, as the JAX package keeps them: delay =
argmax - 1, the +cp/2 re-adjustment without re-reading the window, the
refractory test against the last accepted pointer, the (1 + 1/SNR)
regulariser of the channel estimate, min(corr_obs, 5) history entries, and
the data derotated by delay + 1.

Every function takes a leading stream axis: x [B, n] and every carry field
[B, ...] (``track_frame`` also takes one buffer [n]).  A step keeps static
shapes, makes every branch a ``torch.where`` and waits for nothing on the
host.  ``ceil()`` of the float32 prediction decides a pointer, and with no
drift the prediction is an integer, so :func:`_masked_lstsq` and the
prediction round as the JAX package's CPU build does: the five terms of a
sum added in one fixed order, and a product contracted into the addition
after it, the sums of products included, as XLA's CPU backend emits them
(:func:`_fma32`, :func:`_dot`; the kernel calls ``__fmaf_rn`` at the same
places).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import tracker as tracker_kernel
from ..ops import modulation, sync
from ..ops.zadoff_chu import zc_for_config
from ..utils.device import as_samples, kernel_default, resolve_device
from ..utils.params import OFDMConfig, used_bins
from ..utils.tables import device_table
from . import stream_rx

HISTORY = 5          # entries of the least-squares pointer history


class TrackResult(NamedTuple):
    ptrs: torch.Tensor       # [..., max_det]
    delays: torch.Tensor     # [..., max_det]
    peaks: torch.Tensor      # [..., max_det]
    count: torch.Tensor      # [...]
    chan_freq: torch.Tensor  # [..., max_det, nfft]
    phasors: torch.Tensor    # [..., max_det * nd, num_data_bins]
    hard_bits: torch.Tensor  # [..., max_det * nd * num_data_bins * 2]


class TrackerCarry(NamedTuple):
    """The reference's cross-call tracker state, one row a stream: the
    nine leaves of the JAX package's carry tuple, in its order."""
    loop_count: torch.Tensor  # [B] int32
    corr_obs: torch.Tensor    # [B] int32: -1 searching, else detections
    ptr_frame: torch.Tensor   # [B] int32
    ptr_adj: torch.Tensor     # [B] int32
    sym_count: torch.Tensor   # [B] int32
    last_ptr: torch.Tensor    # [B] int32
    hx: torch.Tensor          # [B, 5] float32
    hy: torch.Tensor          # [B, 5] float32
    b: torch.Tensor           # [B, 2] float32


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with a single rounding.  The product of two float32
    is exact in float64; the sum is rounded to odd there (TwoSum gives its
    exact error), so that the one rounding to float32 after it is the
    correct one."""
    p = a.double() * b.double()
    c = c.double().expand_as(p)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    return torch.where((err != 0) & even, torch.nextafter(s, toward),
                       s).float()


def _total(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as ((((v0 + v1) + v2) + v3) + v4): the order
    ``csrc/tracker.cu`` uses too."""
    s = v[..., 0]
    for i in range(1, v.shape[-1]):
        s = s + v[..., i]
    return s


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_i a_i b_i over the last axis with each product contracted into
    the running sum, fma(a_i, b_i, s) from s = 0 in order, as XLA's CPU
    backend emits a reduction of a product (and ``csrc/tracker.cu``)."""
    s = torch.zeros_like(a[..., 0])
    for i in range(a.shape[-1]):
        s = _fma32(a[..., i], b[..., i], s)
    return s


def _masked_lstsq(hx: torch.Tensor, hy: torch.Tensor,
                  n_eff: torch.Tensor) -> torch.Tensor:
    """Weighted closed form b = argmin sum_i w_i (b0 + b1 x_i - y_i)^2, w_i
    = (i < n_eff): hx, hy [..., 5], n_eff [...] -> [..., 2] float32."""
    idx = torch.arange(hx.shape[-1], device=hx.device)
    w = (idx < n_eff[..., None]).to(torch.float32)
    s0 = _total(w)
    s1 = _total(w * hx)
    s2 = _dot(w * hx, hx)
    sy = _total(w * hy)
    sxy = _dot(w * hx, hy)
    det = _fma32(s0, s2, -(s1 * s1))
    safe = det.abs() > 1e-9
    b1 = torch.where(safe, _fma32(s0, sxy, -(s1 * sy)) /
                     torch.where(safe, det, torch.ones_like(det)),
                     torch.zeros_like(det))
    b0 = torch.where(s0 > 0, _fma32(-b1, s1, sy) / s0.clamp_min(1.0),
                     torch.zeros_like(s0))
    return torch.stack([b0, b1], -1)


def tracker_stride(cfg: OFDMConfig) -> int:
    return int(np.ceil(cfg.cp_len / 2))


def tracker_init_carry(batch: int = 1, device=None) -> TrackerCarry:
    """The empty carry of ``batch`` streams: searching, no history."""
    device = resolve_device(device)

    def i32(v):
        return torch.full((batch,), v, dtype=torch.int32, device=device)

    def f32(k):
        return torch.zeros(batch, k, dtype=torch.float32, device=device)

    return TrackerCarry(i32(0), i32(-1), i32(0), i32(0), i32(0), i32(0),
                        f32(HISTORY), f32(HISTORY), f32(2))


@functools.lru_cache(maxsize=16)
def delay_matrix(cfg: OFDMConfig) -> np.ndarray:
    """[m_synch * num_synch_bins, cp + 1] the +j-signed delay matrix, built
    as the JAX step builds it (``RxBasebandSystem.py:146-152``)."""
    nfft, cp = cfg.nfft, cfg.cp_len
    synch_bins = np.asarray(used_bins(nfft, cfg.num_synch_bins)[1])
    return np.tile(np.exp(1j * 2 * (np.pi / nfft) *
                          np.outer(synch_bins, np.arange(cp + 1))),
                   (cfg.m_synch, 1)).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _window_offsets(cfg: OFDMConfig) -> np.ndarray:
    """[m_synch, nfft] offsets of a step's synch windows from its pointer."""
    return ((np.arange(cfg.m_synch) * cfg.rx_b_len)[:, None] +
            np.arange(cfg.nfft)[None, :])


@functools.lru_cache(maxsize=16)
def _synch_bins(cfg: OFDMConfig) -> np.ndarray:
    return np.asarray(used_bins(cfg.nfft, cfg.num_synch_bins)[1], np.int64)


def _per_stream(v, batch: int, device) -> torch.Tensor:
    """A start or limit as [B] int32: a Python int for every stream (a
    device-side fill) or a tensor of one ([]) or one per stream ([B])."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).expand(batch)
    return torch.full((batch,), v, dtype=torch.int32, device=device)


def make_tracker_step(cfg: OFDMConfig, x: torch.Tensor, x_start,
                      fire_limit):
    """The tracker step over buffers x [B, n] whose first samples have the
    global index ``x_start`` (int, or [] / [B] tensor), as
    ``tracker.py:make_tracker_step``: step(carry) -> (carry, ys), ys =
    (accept [B] bool, ptr [B] int32, delay [B] int32, peak [B] float32,
    h_row [B, nfft] complex64).

    Fire-or-stall: a step fires (reads its window, may accept, consumes a
    loop count) only where the pointer's synch windows end before
    ``fire_limit`` (global) and start at or after ``x_start``; elsewhere
    the carry passes through, so that a chunked stream retries the same
    pointer when more samples arrive.  A step that does not fire still
    correlates the window at x[0] (its outputs are not accepted), as the
    scan does."""
    nfft, cp = cfg.nfft, cfg.cp_len
    m0, rx_b_len, pattern = cfg.m_synch, cfg.rx_b_len, cfg.pattern_len
    batch, n = x.shape
    dev = x.device
    nsb = cfg.num_synch_bins
    L = m0 * nsb
    stride = tracker_stride(cfg)
    start_samp = cp - 5
    thresh = int(np.ceil(0.75 * cp))
    adj = int(np.ceil(0.5 * cp))
    zc_conj = device_table(zc_for_config, dev, cfg).conj()
    p_mat = device_table(delay_matrix, dev, cfg)             # [L, cp + 1]
    bins = device_table(_synch_bins, dev, cfg)
    offs = device_table(_window_offsets, dev, cfg)           # [m0, nfft]
    slots = torch.arange(HISTORY, device=dev)
    x_start = _per_stream(x_start, batch, dev)
    fire_limit = _per_stream(fire_limit, batch, dev)
    denom = 1.0 + 1.0 / cfg.snr_linear

    def correlate(ptr_local):
        idx = (ptr_local.to(torch.int64)[:, None, None] + offs).clamp(0, n - 1)
        w = x.gather(1, idx.reshape(batch, -1)).reshape(batch, m0, nfft)
        sd0 = torch.fft.fft(w, dim=-1)[..., bins].reshape(batch, L)
        pow_est = (sd0.abs() ** 2).sum(-1) / L
        sd = sd0 / torch.sqrt(pow_est.clamp_min(1e-30))[:, None]
        dd = ((sd * zc_conj) @ p_mat).abs()                  # [B, cp + 1]
        dmax, arg = dd.max(-1)
        return sd, dmax, arg.to(torch.int32) - 1

    def step(carry: TrackerCarry):
        (loop_count, corr_obs, ptr_frame, ptr_adj, sym_count, last_ptr,
         hx, hy, b) = carry
        x_hist = (sym_count * pattern).to(torch.float32)
        ptr_pred = torch.ceil(_fma32(b[:, 1], x_hist, b[:, 0]) -
                              cp / 4.0).to(torch.int32)
        ptr = torch.where(
            corr_obs == -1, loop_count * stride + start_samp + ptr_adj,
            torch.where(corr_obs < 5, ptr_frame + pattern * rx_b_len,
                        ptr_pred))

        fire = (((m0 - 1) * rx_b_len + nfft + ptr < fire_limit) &
                (ptr >= x_start))
        sd, dmax, dmax_ind = correlate(torch.where(fire, ptr - x_start, 0))

        enter = fire & ((dmax > 0.5 * L) | (corr_obs > -1))
        # +cp/2 re-adjustment, the same window kept (:163-200)
        need_adj = enter & (dmax_ind > thresh)
        readj = need_adj & (corr_obs == 0)
        ptr_adj1 = torch.where(readj, ptr_adj + adj, ptr_adj)
        ptr = torch.where(
            readj, loop_count * stride + start_samp + ptr_adj1,
            torch.where(need_adj & (corr_obs > 0) & (corr_obs < 5),
                        ptr + adj, ptr))

        refr_ref = torch.where(corr_obs == 0, 0, last_ptr)
        accept = enter & ((ptr - refr_ref > 2 * cp + nfft) | (corr_obs == -1))

        corr_obs1 = torch.where(accept, corr_obs + 1, corr_obs)
        put = accept[:, None] & (slots == (sym_count % HISTORY)[:, None])
        hx1 = torch.where(put, x_hist[:, None], hx)
        hy1 = torch.where(put, (ptr + dmax_ind).to(torch.float32)[:, None],
                          hy)
        sym_count1 = torch.where(accept, sym_count + 1, sym_count)
        n_eff = corr_obs1.clamp_max(HISTORY)
        b1 = torch.where((accept & (corr_obs1 > 3))[:, None],
                         _masked_lstsq(hx1, hy1, n_eff), b)

        # channel estimate on accept (:229-241)
        col = (dmax_ind + 1).clamp(0, cp).to(torch.int64)
        tmp = (sd * p_mat.t().index_select(0, col)) * zc_conj / denom
        h_est = tmp.reshape(batch, m0, nsb).mean(1)
        h_row = torch.zeros(batch, nfft, dtype=torch.complex64,
                            device=dev).index_copy(1, bins, h_est)
        h_row = torch.where(accept[:, None], h_row, 0)

        carry1 = TrackerCarry(
            torch.where(fire, loop_count + 1, loop_count), corr_obs1,
            torch.where(fire, ptr, ptr_frame), ptr_adj1, sym_count1,
            torch.where(accept, ptr, last_ptr), hx1, hy1, b1)
        return carry1, (accept, ptr, dmax_ind, dmax, h_row)

    return step


def emit_channels(accepted: torch.Tensor, h_all: torch.Tensor,
                  max_det: int) -> torch.Tensor:
    """The channel rows h_all [B, steps, nfft] of the accepted steps, in
    order, in a [B, max_det, nfft] table (zero rows past the count): the
    channel table ``kernels/tracker.py:track_scan`` returns."""
    slot = accepted.to(torch.int64).cumsum(-1) - 1
    tgt = torch.where(accepted & (slot < max_det), slot, max_det)
    b, _, nfft = h_all.shape
    out = h_all.new_zeros(b, max_det + 1, nfft)
    return out.scatter(1, tgt[..., None].expand(h_all.shape),
                       h_all)[:, :max_det]


def demod_track_table(cfg: OFDMConfig, x: torch.Tensor, ptrs_local,
                      delays, det_valid, readable_local):
    """The data windows of a tracker detection table
    (``tracker.py:demod_track_table``, ``RxBasebandSystem.rx_data_demod``
    :276-309): x [B, n], ptrs_local / delays / det_valid [B, max_det]
    relative to x[:, 0], readable_local (int or [B]) the real samples.
    Data symbol j of a detection starts (j + 1) * (nfft + cp) after its
    pointer, whatever m_synch is, as in the reference.

    Returns (win [B, max_det, nd, nfft], rot [B, max_det, 1, num_data_bins]
    the derotation by delay + 1, ok [B, max_det, nd] the window lies in the
    readable samples)."""
    nfft, nd = cfg.nfft, cfg.synch_dat[1]
    dev = x.device
    starts = (ptrs_local.to(torch.int64)[..., None] +
              (torch.arange(nd, device=dev) + 1) * cfg.rx_b_len)
    readable = sync.scalar_like(readable_local, x, torch.int64)
    if readable.ndim:
        readable = readable[:, None, None]
    ok = det_valid[..., None] & (starts + nfft <= readable)
    win = sync.windows_at(x, torch.where(ok, starts, 0),
                          torch.arange(nfft, device=dev))
    data_bins = device_table(sync._bins, dev, nfft, cfg.num_data_bins)
    rot = torch.exp((1j * 2.0 * np.pi / nfft) *
                    (delays[..., None, None] + 1).to(torch.float32) *
                    data_bins.to(torch.float32))
    return win, rot, ok


def track_phasors(cfg: OFDMConfig, x: torch.Tensor, ptrs_local, delays,
                  det_valid, readable_local, chans: torch.Tensor,
                  demod_path: str | None = None) -> torch.Tensor:
    """Equalised data of a detection table (``track_frame`` :228-234):
    the power-normalised data-bin spectra times the coefficient row rot *
    conj(h) / (|h|^2 + 1/snr) of each detection, then each symbol scaled to
    unit mean power and masked by ``ok``.  ``demod_path`` as in
    ``stream_rx.demod_rows`` ("kernel": K2, one launch over the table).
    Returns [B, max_det, nd, num_data_bins]."""
    win, rot, ok = demod_track_table(cfg, x, ptrs_local, delays, det_valid,
                                     readable_local)
    data_bins = device_table(sync._bins, x.device, cfg.nfft,
                             cfg.num_data_bins)
    coeff = rot * sync.mmse_gain(chans[..., data_bins], cfg.snr_linear
                                 )[..., None, :]
    eq = stream_rx.demod_rows(cfg, win, coeff, demod_path)
    p1 = (eq.abs() ** 2).mean(-1, keepdim=True)
    return eq / torch.sqrt(p1.clamp_min(1e-30)) * ok[..., None]


def track_frame(cfg: OFDMConfig, x: torch.Tensor, total_loops: int,
                max_det: int, scan: str | None = None,
                demod_path: str | None = None) -> TrackResult:
    """The tracker over whole buffers x [B, n] (or one buffer [n]): one
    ``track_scan`` of ``total_loops`` steps (it returns the channel table
    compacted), the accepted steps' pointers, delays and peaks compacted
    into a [max_det] table, then the data demod and the QPSK hard bits per
    buffer (``tracker.py:track_frame``, vmapped).  ``scan`` None runs
    ``kernels/tracker.py:track_scan`` (the kernel on a CUDA tensor), "plain"
    its plain twin; ``demod_path`` as in :func:`track_phasors`."""
    if scan not in (None, "plain"):
        raise ValueError(f"unknown tracker scan {scan!r}")
    one = x.ndim == 1
    xb = x[None] if one else x
    batch, n = xb.shape
    run = (tracker_kernel.track_scan if scan is None
           else tracker_kernel.track_scan_plain)
    _, ys = run(cfg, xb, 0, n, tracker_init_carry(batch, xb.device),
                total_loops, max_det)
    out = track_result(cfg, xb, ys, demod_path)
    return TrackResult(*(f[0] for f in out)) if one else out


def track_result(cfg: OFDMConfig, x: torch.Tensor, ys,
                 demod_path: str | None = None) -> TrackResult:
    """:func:`track_frame` after its scan: the outputs ``ys`` of a
    ``track_scan`` over whole buffers x [B, n] (channel table [B, max_det,
    nfft]) -> the detection table, the demod and the QPSK hard bits."""
    acc, ptrs_all, dels_all, peaks_all, chan = ys
    batch, max_det = chan.shape[:2]
    (ptrs, delays, peaks), count = sync.emit_slots(
        acc, (ptrs_all, dels_all, peaks_all), max_det)
    det_valid = torch.arange(max_det, device=x.device) < count[:, None]
    phasors = track_phasors(cfg, x, ptrs, delays, det_valid, x.shape[1],
                            chan, demod_path).reshape(
                                batch, max_det * cfg.synch_dat[1], -1)
    hard, _, _ = modulation.qpsk_llr_frames(phasors)
    return TrackResult(ptrs, delays, peaks, count, chan, phasors, hard)


def make_tracker(cfg: OFDMConfig, n_samples: int, max_det: int | None = None,
                 device=None, scan: str | None = None,
                 demod_path: str | None = None):
    """track_frame bound to a buffer length (``tracker.py:make_tracker``):
    ceil(n / stride) + 1 steps, ``max_det`` num_patterns unless given.  The
    returned function takes the samples ([n] or [B, n], a tensor or
    anything numpy takes) to the CUDA device, or to ``device``; on a CUDA
    device the demod defaults to K2."""
    total_loops = int(np.ceil(n_samples / tracker_stride(cfg))) + 1
    if max_det is None:
        max_det = cfg.num_patterns
    device = resolve_device(device)
    fn = functools.partial(track_frame, cfg, total_loops=total_loops,
                           max_det=max_det, scan=scan,
                           demod_path=kernel_default(device, demod_path))
    return lambda x: fn(as_samples(x, device))
