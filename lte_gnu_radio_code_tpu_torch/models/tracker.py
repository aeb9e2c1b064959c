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
host.

The fit is exact on an unbounded stream.  ``ceil()`` of the prediction
decides a pointer, and a pointer is a global sample index, past 2^24 (the
last integer float32 holds) after 1.1 s of a 15.36 Msps stream; the JAX
package keeps the history as float32 global indices and fits on them, and
loses the block cadence there.  Here the history is int32 (``hx`` the
entry's sym_count * pattern, ``hy`` its symbol boundary ptr + delay), and
:func:`_masked_lstsq` fits in float32 on differences from the newest entry:
x in patterns (0 to -4), y in samples (four patterns at most), so every sum
and every product of two sums is an integer below 2^24, exact.  The fitted
value at the next entry's x is their quotient (one rounding), and
ceil(quotient - cp/4) is the exact ceiling: the true value is a multiple of
1 / (4 det), det <= 50, so it is an integer (which float32 holds) or lies
farther from one than the rounding moves it.  The int32 anchor, the
newest entry's y, is added after the ceil.  The CUDA kernel computes the
same operations, which are exact, so both routes equal the plain step bit
for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import tracker as tracker_kernel
from ..ops import modulation, sync
from ..ops.zadoff_chu import zc_for_config
from ..utils.device import as_samples, resolve_device
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
    hx: torch.Tensor          # [B, 5] int32: an entry's sym_count * pattern
    hy: torch.Tensor          # [B, 5] int32: its ptr + delay (global)
    b: torch.Tensor           # [B, 2] float32: the fit (_masked_lstsq)


def _masked_lstsq(hx: torch.Tensor, hy: torch.Tensor, n_eff: torch.Tensor,
                  newest: torch.Tensor, pattern: int) -> torch.Tensor:
    """The least-squares line b0 + b1 x through the history entries i <
    n_eff (hx, hy [..., 5] int32, n_eff [...]), relative to entry
    ``newest`` ([...]: the one just written, whose x is the largest):
    returns [..., 2] float32, b[0] = the line at the next entry's x (the
    newest's + pattern) less the newest's y, b[1] its slope in samples per
    unit of x.  Zero where fewer than two entries count.

    In float32 on differences from the newest entry, x in patterns: u_i =
    (hx_i - hx_newest) / pattern in [-4, 0], v_i = hy_i - hy_newest.  The
    sums and the products of two sums are integers below 2^24 (module
    docstring), so b[0] = (s2 sy - s1 sxy + s0 sxy - s1 sy) / det has one
    rounding, b[1] = (s0 sxy - s1 sy) / (det pattern) one."""
    idx = torch.arange(hx.shape[-1], device=hx.device)
    w = idx < n_eff[..., None]
    at = newest[..., None].to(torch.int64)
    u = torch.where(w, torch.div(hx - hx.gather(-1, at), pattern,
                                 rounding_mode="floor"), 0).to(torch.float32)
    v = torch.where(w, hy - hy.gather(-1, at), 0).to(torch.float32)
    s0 = w.to(torch.float32).sum(-1)
    s1, s2 = u.sum(-1), (u * u).sum(-1)
    sy, sxy = v.sum(-1), (u * v).sum(-1)
    det = s0 * s2 - s1 * s1
    num1 = s0 * sxy - s1 * sy
    safe = det > 0
    det = torch.where(safe, det, torch.ones_like(det))
    b0 = (s2 * sy - s1 * sxy + num1) / det
    b1 = num1 / (det * pattern)
    zero = torch.zeros_like(det)
    return torch.stack([torch.where(safe, b0, zero),
                        torch.where(safe, b1, zero)], -1)


def _predict(hy: torch.Tensor, b: torch.Tensor, sym_count: torch.Tensor,
             cp: int) -> torch.Tensor:
    """The drift prediction ceil(fit at sym_count * pattern - cp/4), as an
    int32 global pointer: the newest entry's y (slot (sym_count - 1) mod
    5) plus ceil(b[0] - cp/4)."""
    at = ((sym_count + HISTORY - 1) % HISTORY)[:, None].to(torch.int64)
    return hy.gather(1, at)[:, 0] + torch.ceil(b[:, 0] - cp / 4.0).to(
        torch.int32)


def tracker_stride(cfg: OFDMConfig) -> int:
    return int(np.ceil(cfg.cp_len / 2))


def tracker_init_carry(batch: int = 1, device=None) -> TrackerCarry:
    """The empty carry of ``batch`` streams: searching, no history."""
    device = resolve_device(device)

    def i32(v):
        return torch.full((batch,), v, dtype=torch.int32, device=device)

    def zeros(k, dtype):
        return torch.zeros(batch, k, dtype=dtype, device=device)

    return TrackerCarry(i32(0), i32(-1), i32(0), i32(0), i32(0), i32(0),
                        zeros(HISTORY, torch.int32),
                        zeros(HISTORY, torch.int32), zeros(2, torch.float32))


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
        ptr = torch.where(
            corr_obs == -1, loop_count * stride + start_samp + ptr_adj,
            torch.where(corr_obs < 5, ptr_frame + pattern * rx_b_len,
                        _predict(hy, b, sym_count, cp)))

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
        newest = sym_count % HISTORY
        put = accept[:, None] & (slots == newest[:, None])
        hx1 = torch.where(put, (sym_count * pattern)[:, None], hx)
        hy1 = torch.where(put, (ptr + dmax_ind)[:, None], hy)
        sym_count1 = torch.where(accept, sym_count + 1, sym_count)
        n_eff = corr_obs1.clamp_max(HISTORY)
        b1 = torch.where((accept & (corr_obs1 > 3))[:, None],
                         _masked_lstsq(hx1, hy1, n_eff, newest, pattern), b)

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
    rot = sync.derotation(nfft, delays[..., None] + 1, device_table(
        sync._bins, dev, nfft, cfg.num_data_bins))
    return win, rot, ok


def track_phasors(cfg: OFDMConfig, x: torch.Tensor, ptrs_local, delays,
                  det_valid, readable_local,
                  chans: torch.Tensor) -> torch.Tensor:
    """Equalised data of a detection table (``track_frame`` :228-234):
    the power-normalised data-bin spectra times the coefficient row rot *
    conj(h) / (|h|^2 + 1/snr) of each detection, then each symbol scaled to
    unit mean power and masked by ``ok``; the spectra from K2, one launch
    over the table (``stream_rx.demod_rows``).  Returns [B, max_det, nd,
    num_data_bins]."""
    win, rot, ok = demod_track_table(cfg, x, ptrs_local, delays, det_valid,
                                     readable_local)
    data_bins = device_table(sync._bins, x.device, cfg.nfft,
                             cfg.num_data_bins)
    coeff = rot * sync.mmse_gain(chans[..., data_bins], cfg.snr_linear
                                 )[..., None, :]
    eq = stream_rx.demod_rows(cfg, win, coeff)
    p1 = (eq.abs() ** 2).mean(-1, keepdim=True)
    return eq / torch.sqrt(p1.clamp_min(1e-30)) * ok[..., None]


def track_frame(cfg: OFDMConfig, x: torch.Tensor, total_loops: int,
                max_det: int) -> TrackResult:
    """The tracker over whole buffers x [B, n] (or one buffer [n]): one
    ``track_scan`` of ``total_loops`` steps (it returns the channel table
    compacted), the accepted steps' pointers, delays and peaks compacted
    into a [max_det] table, then the data demod and the QPSK hard bits per
    buffer (``tracker.py:track_frame``, vmapped).  The scan is
    ``kernels/tracker.py:track_scan``: the kernel on a CUDA tensor, its
    plain twin on a CPU tensor."""
    one = x.ndim == 1
    xb = x[None] if one else x
    batch, n = xb.shape
    _, ys = tracker_kernel.track_scan(
        cfg, xb, 0, n, tracker_init_carry(batch, xb.device), total_loops,
        max_det)
    out = track_result(cfg, xb, ys)
    return TrackResult(*(f[0] for f in out)) if one else out


def track_result(cfg: OFDMConfig, x: torch.Tensor, ys) -> TrackResult:
    """:func:`track_frame` after its scan: the outputs ``ys`` of a
    ``track_scan`` over whole buffers x [B, n] (channel table [B, max_det,
    nfft]) -> the detection table, the demod and the QPSK hard bits."""
    acc, ptrs_all, dels_all, peaks_all, chan = ys
    batch, max_det = chan.shape[:2]
    (ptrs, delays, peaks), count = sync.emit_slots(
        acc, (ptrs_all, dels_all, peaks_all), max_det)
    det_valid = torch.arange(max_det, device=x.device) < count[:, None]
    phasors = track_phasors(cfg, x, ptrs, delays, det_valid, x.shape[1],
                            chan).reshape(
                                batch, max_det * cfg.synch_dat[1], -1)
    hard, _, _ = modulation.qpsk_llr_frames(phasors)
    return TrackResult(ptrs, delays, peaks, count, chan, phasors, hard)


def make_tracker(cfg: OFDMConfig, n_samples: int, max_det: int | None = None,
                 device=None):
    """track_frame bound to a buffer length (``tracker.py:make_tracker``):
    ceil(n / stride) + 1 steps, ``max_det`` num_patterns unless given.  The
    returned function takes the samples ([n] or [B, n], a tensor or
    anything numpy takes) to the CUDA device, or to ``device``."""
    total_loops = int(np.ceil(n_samples / tracker_stride(cfg))) + 1
    if max_det is None:
        max_det = cfg.num_patterns
    device = resolve_device(device)
    fn = functools.partial(track_frame, cfg, total_loops=total_loops,
                           max_det=max_det)
    return lambda x: fn(as_samples(x, device))
