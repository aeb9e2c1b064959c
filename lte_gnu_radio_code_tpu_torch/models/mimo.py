"""2x2 MIMO in torch: spatial multiplexing (SpMult) and the Alamouti
space-time block code (STCode), the two modes the reference declares and
leaves unimplemented (MultiAntennaSystem.multi_ant_binary_map:184-186,
RxBasebandSystem.rx_data_demod:313-318).

Port of ``lte_gnu_radio_code_tpu/models/mimo.py`` (``MimoRxResult``,
``StcRxResult``, ``tx_frame_mimo``, ``_inv2x2``, ``rx_frame_mimo``,
``tx_frame_stcode``, ``rx_frame_stcode``, ``make_mimo_chain``,
``make_stcode_chain``), its docstrings giving the design: synch_dat =
(2, nd), the pattern's two synch symbols carry ZC slice 0 on antenna 0 and
slice 1 on antenna 1, so the receiver estimates the whole 2x2 channel per
bin.  Every function takes leading frame axes: bits [..., 2, n] or
[..., n], signals [..., 2, T].

The search runs on RX antenna 0 against slice 0 alone: K4
(``kernels/sync_search.py``) with the single-synch view of the config
(:func:`search_config`) and the ZC slice as its sequence, then
``ops/sync.py:lock_from_peaks``.  Pilots, data windows and the per-bin 2x2
detection stay raw and in plain torch: K2 would normalise each window's
power, which the receiver leaves to one scale per stream at the end, and
the TX norms are not K1's.  The chains run on the CUDA device unless asked
for the CPU, and draw their noise from a ``torch.Generator`` or take a
noise tensor.

Tracing (``utils/profiling.py``): a chain step is the root span
``ofdm.chain_step``; inside it ``ofdm.tx`` (both antennas' TX, the 2x2
channel, power, AWGN), ``ofdm.search`` (K4), ``ofdm.lock``
(``lock_from_peaks``), ``ofdm.estimate`` (the pilot windows, their FFT,
the 2x2 LS estimate and its common scale), ``ofdm.demod`` (the data
windows, their FFT, the derotation), ``ofdm.detect`` (SpMult: W, its
product with every data symbol, each stream's unit power; STCode: the
Alamouti combining) and ``ofdm.demap`` (the hard decisions).  Counter
``ofdm.detect_frames``: the frames whose SpMult LMMSE a step ran, kept
while a profiler records.  ``reference_cpu/mimo.py`` is the SpMult link's
plain float64 reference.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import sync_search
from ..ops import channel as chan_ops
from ..ops import modulation, sync
from ..ops.zadoff_chu import zc_for_config
from ..utils import profiling
from ..utils.device import resolve_device
from ..utils.params import OFDMConfig, used_bins
from ..utils.tables import device_table
from . import rxofdm


class MimoRxResult(NamedTuple):
    phasors: torch.Tensor      # [..., 2, num_data_symb, num_data_bins]
    hard_bits: torch.Tensor    # [..., 2, bits_per_stream]
    lock_ptr: torch.Tensor     # [...]
    delay_idx: torch.Tensor
    found: torch.Tensor
    chan_freq: torch.Tensor    # [..., 2, 2, nfft], [rx, tx, bin]


class StcRxResult(NamedTuple):
    phasors: torch.Tensor      # [..., num_data_symb, num_data_bins]
    hard_bits: torch.Tensor    # [..., num_bits]
    lock_ptr: torch.Tensor
    delay_idx: torch.Tensor
    found: torch.Tensor
    chan_freq: torch.Tensor    # [..., 2, 2, nfft]


class MimoChainResult(NamedTuple):
    ber: torch.Tensor          # [..., 2] SpMult (per stream), [...] STCode
    found: torch.Tensor        # [...]
    lock_ptr: torch.Tensor
    delay_idx: torch.Tensor
    hard_bits: torch.Tensor    # as the receiver's result
    phasors: torch.Tensor      # as the receiver's result
    chan_freq: torch.Tensor    # [..., 2, 2, nfft], [rx, tx, bin]


def _check(cfg: OFDMConfig) -> None:
    if cfg.num_ant_txrx != 2 or cfg.m_synch != 2:
        raise ValueError("2x2 MIMO needs num_ant_txrx=2 and synch_dat=(2, nd)")


def _check_stc(cfg: OFDMConfig) -> None:
    _check(cfg)
    if cfg.synch_dat[1] % 2:
        raise ValueError("STCode pairs consecutive data symbols; "
                         "synch_dat[1] must be even")


@functools.lru_cache(maxsize=16)
def search_config(cfg: OFDMConfig) -> OFDMConfig:
    """The single-synch view the search runs with: synch_dat (1, nd), one
    antenna, one pattern long.  The search reads no symbol count (only
    m_synch, the widths, the stride, the synch bins and the gate), so a
    2x2 frame of any whole number of its own (2, nd) patterns has a valid
    view.  Its own ZC sequence is another one (length num_synch_bins): the
    search correlates with :func:`_search_zc` instead."""
    nd = cfg.synch_dat[1]
    return dataclasses.replace(cfg, synch_dat=(1, nd), num_ofdm_symb=1 + nd,
                               num_ant_txrx=1).validate()


@functools.lru_cache(maxsize=16)
def _search_zc(cfg: OFDMConfig) -> np.ndarray:
    """Slice 0 of the config's ZC sequence: antenna 0's pilot."""
    return zc_for_config(cfg)[:cfg.num_synch_bins]


def plan(cfg: OFDMConfig, n_samples: int) -> tuple[int, int]:
    """(n_trials, num_patterns) of a buffer of n_samples
    (``make_mimo_chain``'s): the trials of the single-synch search, the
    patterns of the 2x2 frame."""
    return (sync.n_trials_for(search_config(cfg), n_samples),
            rxofdm.plan_rx(cfg, n_samples)[1])


# -- constant tables ---------------------------------------------------------

def _rows(cfg: OFDMConfig, kind: int) -> np.ndarray:
    return np.where(np.asarray(cfg.symbol_pattern()) == kind)[0]


@functools.lru_cache(maxsize=16)
def _pilot_grid(cfg: OFDMConfig) -> np.ndarray:
    """[2, num_ofdm_symb, nfft]: antenna a's ZC slice a on its synch rows
    (the pattern's synch symbols alternate between the antennas)."""
    _, synch_bins = used_bins(cfg.nfft, cfg.num_synch_bins)
    zc = zc_for_config(cfg).reshape(2, cfg.num_synch_bins)
    grid = np.zeros((2, cfg.num_ofdm_symb, cfg.nfft), np.complex64)
    synch_rows = _rows(cfg, 0)
    for ant in range(2):
        grid[ant][np.ix_(synch_rows[ant::2], np.asarray(synch_bins))] = \
            zc[ant][None, :]
    return grid


def _data_rows(cfg: OFDMConfig) -> np.ndarray:
    return _rows(cfg, 1).astype(np.int64)


def _zc_slices(cfg: OFDMConfig) -> np.ndarray:
    """[2, num_synch_bins]: the pilot slice of each TX antenna."""
    return zc_for_config(cfg).reshape(2, cfg.num_synch_bins)


@functools.lru_cache(maxsize=16)
def _pilot_offsets(cfg: OFDMConfig) -> np.ndarray:
    """[2, nfft]: the two pilot windows' offsets from the lock pointer."""
    return (np.arange(2)[:, None] * cfg.rx_b_len +
            np.arange(cfg.nfft)[None, :])


@functools.lru_cache(maxsize=16)
def _pair_slots(cfg: OFDMConfig) -> np.ndarray:
    """[num_ofdm_symb] int64: the data pair of each data row; pilot rows
    go to the extra last slot num_data_symb // 2 (JAX's index -1)."""
    is_data = np.asarray(cfg.symbol_pattern()) == 1
    pair = (np.cumsum(is_data) - 1) // 2
    return np.where(is_data, pair, cfg.num_data_symb // 2).astype(np.int64)


@functools.lru_cache(maxsize=16)
def _is_data(cfg: OFDMConfig) -> np.ndarray:
    return (np.asarray(cfg.symbol_pattern()) == 1).astype(np.int32)


# -- TX ----------------------------------------------------------------------

def _grid(cfg: OFDMConfig, data: torch.Tensor) -> torch.Tensor:
    """The two antennas' grids [..., 2, num_ofdm_symb, nfft]: the pilots,
    and data [..., 2, num_data_symb, num_data_bins] on the data rows."""
    dev = data.device
    lead = data.shape[:-3]
    pilots = device_table(_pilot_grid, dev, cfg)
    grid = pilots.expand(*lead, *pilots.shape).clone()
    rows = device_table(_data_rows, dev, cfg)
    bins = sync._bins_on(dev, cfg.nfft, cfg.num_data_bins)
    grid[..., rows[:, None], bins] = data
    return grid


def _cp_symbols(cfg: OFDMConfig, grid: torch.Tensor):
    """IDFT of every row plus its cyclic prefix, and each row's energy:
    ([..., rows, nfft + cp], [..., rows])."""
    t = torch.fft.ifft(grid, cfg.nfft, dim=-1)
    t = torch.cat([t[..., -cfg.cp_len:], t], -1)
    return t, (t.abs() ** 2).sum(-1)


def _scaled(t: torch.Tensor, energy: torch.Tensor) -> torch.Tensor:
    """Each row scaled to unit mean power; a silent row stays zero."""
    scale = torch.where(energy > 1e-20,
                        torch.sqrt(t.shape[-1] / energy.clamp_min(1e-20)),
                        0.0)
    out = t * scale[..., None]
    return out.reshape(*out.shape[:-2], -1).to(torch.complex64)


def tx_frame_mimo(cfg: OFDMConfig, bits: torch.Tensor) -> torch.Tensor:
    """[..., 2, num_bits] -> [..., 2, frame_len]: two independent streams
    on the same bins (``mimo.py:tx_frame_mimo``).  Each antenna's symbols
    are scaled by their own energy; rows where an antenna is silent stay
    zero."""
    _check(cfg)
    pts = modulation.bits_to_symbols(bits, cfg.modulation)
    data = pts.reshape(*pts.shape[:-1], cfg.num_data_symb, cfg.num_data_bins)
    t, energy = _cp_symbols(cfg, _grid(cfg, data))
    return _scaled(t, energy)


def tx_frame_stcode(cfg: OFDMConfig, bits: torch.Tensor) -> torch.Tensor:
    """[..., num_bits] -> [..., 2, frame_len] Alamouti-coded
    (``mimo.py:tx_frame_stcode``): per bin and pair of data symbols
    (s0, s1), antenna 0 sends s0, -conj(s1), antenna 1 s1, conj(s0).  The
    two rows of a pair share one scale, their mean energy, so the code
    survives the TX normalisation; pilot rows keep their own."""
    _check_stc(cfg)
    dev = bits.device
    pts = modulation.bits_to_symbols(bits, cfg.modulation)
    pts = pts.reshape(*pts.shape[:-1], cfg.num_data_symb // 2, 2,
                      cfg.num_data_bins)
    s0, s1 = pts[..., 0, :], pts[..., 1, :]            # [..., pairs, B]
    ant0 = torch.stack([s0, -s1.conj()], -2)
    ant1 = torch.stack([s1, s0.conj()], -2)
    data = torch.stack([ant0, ant1], -4).reshape(
        *pts.shape[:-3], 2, cfg.num_data_symb, cfg.num_data_bins)
    t, energy = _cp_symbols(cfg, _grid(cfg, data))
    is_data = device_table(_is_data, dev, cfg) == 1
    slots = device_table(_pair_slots, dev, cfg)
    pair_energy = energy.new_zeros(*energy.shape[:-1],
                                   cfg.num_data_symb // 2 + 1).index_add_(
        -1, slots, torch.where(is_data, energy, 0.0))
    e_eff = torch.where(is_data, pair_energy[..., slots] / 2.0, energy)
    return _scaled(t, e_eff)


# -- RX ----------------------------------------------------------------------

def _inv2x2(h: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of [..., 2, 2] complex matrices."""
    a, b = h[..., 0, 0], h[..., 0, 1]
    c, d = h[..., 1, 0], h[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    row0 = torch.stack([d, -b], -1)
    row1 = torch.stack([-c, a], -1)
    return torch.stack([row0, row1], -2) * inv_det[..., None, None]


def _front(cfg: OFDMConfig, y: torch.Tensor, n_trials: int,
           num_patterns: int):
    """What both modes share: the search on RX antenna 0 against slice 0,
    the 2x2 LS channel estimate from the two time-orthogonal pilots (raw:
    a pilot is silent on the other antenna, so normalising its window would
    blow noise up), one common scale on it, and the derotated data bins of
    every data symbol on both RX antennas.  Returns (ptr, delay, found,
    chan_freq [..., 2, 2, nfft], data [..., 2, num_patterns*nd, B]).  Spans
    ``ofdm.search``, ``ofdm.lock``, ``ofdm.estimate``, ``ofdm.demod``."""
    dev = y.device
    cfg1 = search_config(cfg)
    with profiling.span("ofdm.search"):
        peaks = sync_search.sync_peaks(cfg1, y[..., 0, :].contiguous(),
                                       n_trials, zc=_search_zc(cfg))
    with profiling.span("ofdm.lock"):
        ptr, delay, _, found, _ = sync.lock_from_peaks(cfg1, *peaks)
    starts = ptr[..., None].expand(*y.shape[:-1])      # one per RX antenna

    with profiling.span("ofdm.estimate"):
        seg = cfg.num_synch_bins
        synch_bins = sync._bins_on(dev, cfg.nfft, seg)
        rot = sync.derotation(cfg.nfft, delay, synch_bins)
        win = sync.windows_at(y, starts, device_table(_pilot_offsets, dev,
                                                      cfg))
        s = torch.fft.fft(win, cfg.nfft, dim=-1)[..., synch_bins]
        h_bins = (s * rot[..., None, None, :]) * \
            device_table(_zc_slices, dev, cfg).conj()  # [..., rx, tx, L]
        power = (h_bins.abs() ** 2).sum((-3, -2, -1), keepdim=True)
        h_bins = h_bins * torch.sqrt(4 * seg / power.clamp_min(1e-30))
        chan = h_bins.new_zeros(*h_bins.shape[:-1], cfg.nfft)
        chan[..., synch_bins] = h_bins

    with profiling.span("ofdm.demod"):
        data_bins = sync._bins_on(dev, cfg.nfft, cfg.num_data_bins)
        rot_d = sync.derotation(cfg.nfft, delay, data_bins)
        win = sync.windows_at(y, starts, device_table(
            sync.data_window_offsets, dev, cfg, num_patterns))
        fd = torch.fft.fft(win, cfg.nfft, dim=-1)[..., data_bins]
        fd = fd * rot_d[..., None, None, :]
    return ptr, delay, found, chan, fd


def _unit_power(ph: torch.Tensor) -> torch.Tensor:
    """Scaled to unit mean power over the last two axes."""
    p = (ph.abs() ** 2).mean((-2, -1), keepdim=True)
    return ph * torch.rsqrt(p.clamp_min(1e-30))


def _hard(cfg: OFDMConfig, ph: torch.Tensor) -> torch.Tensor:
    """Hard bits of each stream [..., K, B] -> [..., K*B*bits_per_bin]:
    the QPSK demap with its sigma over the stream alone, else max-log at
    noise variance 1 / snr."""
    lead = ph.shape[:-2]
    if cfg.modulation == "QPSK":
        hard, _, _ = modulation.qpsk_llr_frames(ph.reshape(-1, ph.shape[-2],
                                                           ph.shape[-1]))
    else:
        hard, _ = modulation.maxlog_llr(ph, cfg.modulation,
                                        1.0 / cfg.snr_linear)
    return hard.reshape(*lead, -1)


def rx_frame_mimo(cfg: OFDMConfig, y: torch.Tensor, n_trials: int,
                  num_patterns: int) -> MimoRxResult:
    """[..., 2, n] received -> two demodulated streams
    (``mimo.py:rx_frame_mimo``): per-bin 2x2 LMMSE W = (H^H H + I/snr)^-1
    H^H, then each stream scaled to unit power.  Spans those of
    :func:`_front`, ``ofdm.detect`` and ``ofdm.demap``; counter
    ``ofdm.detect_frames``."""
    _check(cfg)
    ptr, delay, found, chan, fd = _front(cfg, y, n_trials, num_patterns)
    dev = y.device
    with profiling.span("ofdm.detect"):
        hd = chan[..., sync._bins_on(dev, cfg.nfft, cfg.num_data_bins)]
        hd = hd.movedim(-1, -3)                         # [..., B, rx, tx]
        hh = hd.conj().transpose(-1, -2)
        eye = torch.eye(2, dtype=hd.dtype, device=dev)
        w = _inv2x2(hh @ hd + (1.0 / cfg.snr_linear) * eye) @ hh
        yv = fd.movedim(-3, -1)[..., None]              # [..., KN, B, 2, 1]
        xhat = (w[..., None, :, :, :] @ yv)[..., 0]     # [..., KN, B, 2]
        ph = _unit_power(xhat.movedim(-1, -3))          # [..., 2, KN, B]
    profiling.count("ofdm.detect_frames", found.numel())
    with profiling.span("ofdm.demap"):
        hard = _hard(cfg, ph)
    return MimoRxResult(ph, hard, ptr, delay, found, chan)


def rx_frame_stcode(cfg: OFDMConfig, y: torch.Tensor, n_trials: int,
                    num_patterns: int) -> StcRxResult:
    """[..., 2, n] received -> one Alamouti-combined stream
    (``mimo.py:rx_frame_stcode``): per bin and pair, over both RX antennas,
    s0 = sum conj(h_r0) y_r(t) + h_r1 conj(y_r(t+1)), s1 = sum conj(h_r1)
    y_r(t) - h_r0 conj(y_r(t+1)), over sum |h|^2 + 2/snr.  Spans those of
    :func:`_front`, ``ofdm.detect`` and ``ofdm.demap``."""
    _check_stc(cfg)
    ptr, delay, found, chan, fd = _front(cfg, y, n_trials, num_patterns)
    nd, nb = cfg.synch_dat[1], cfg.num_data_bins
    with profiling.span("ofdm.detect"):
        pairs = fd.reshape(*fd.shape[:-2], num_patterns, nd // 2, 2, nb)
        y_t, y_t1 = pairs[..., 0, :], pairs[..., 1, :]  # [..., rx, K, P, B]
        hd = chan[..., sync._bins_on(y.device, cfg.nfft, nb)]
        h0 = hd[..., 0, :][..., None, None, :]          # [..., rx, 1, 1, B]
        h1 = hd[..., 1, :][..., None, None, :]
        s0 = (h0.conj() * y_t + h1 * y_t1.conj()).sum(-4)
        s1 = (h1.conj() * y_t - h0 * y_t1.conj()).sum(-4)
        norm = (hd.abs() ** 2).sum((-3, -2))[..., None, None, :] + \
            2.0 / cfg.snr_linear
        shat = torch.stack([s0 / norm, s1 / norm], -2)  # [..., K, P, 2, B]
        ph = _unit_power(shat.reshape(*shat.shape[:-4], num_patterns * nd,
                                      nb))
    with profiling.span("ofdm.demap"):
        hard = _hard(cfg, ph)
    return StcRxResult(ph, hard, ptr, delay, found, chan)


# -- loopback chains -----------------------------------------------------------

def _ber(hard: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    nb = min(hard.shape[-1], bits.shape[-1])
    return (hard[..., :nb] != bits[..., :nb]).to(torch.float32).mean(-1)


def _make_chain(cfg: OFDMConfig, channel: str, device, tx, rx):
    dev = resolve_device(device)
    n = cfg.frame_len + cfg.nfft - 1
    n_trials, num_patterns = plan(cfg, n)
    h = torch.from_numpy(chan_ops.mimo2_taps(channel)).to(dev)

    def step(bits, *, generator: torch.Generator | None = None,
             noise: torch.Tensor | None = None) -> MimoChainResult:
        with profiling.span("ofdm.chain_step"):
            bits = torch.as_tensor(bits, device=dev)
            with profiling.span("ofdm.tx"):
                sig = tx(cfg, bits)                     # [..., 2, T]
                clean = chan_ops.apply_channel_mimo(sig, h,
                                                    max_impulse=cfg.nfft)
                sig_pow = (sig.abs() ** 2).mean((-2, -1))
                y = chan_ops.awgn(cfg, clean, sig_pow[..., None, None],
                                  generator=generator, noise=noise)
            r = rx(cfg, y, n_trials, num_patterns)
            return MimoChainResult(_ber(r.hard_bits, bits), r.found,
                                   r.lock_ptr, r.delay_idx, r.hard_bits,
                                   r.phasors, r.chan_freq)

    return step


def make_mimo_chain(cfg: OFDMConfig, channel: str = "Fading", device=None):
    """The 2x2 SpMult loopback (``mimo.py:make_mimo_chain``): step(bits
    [..., 2, num_bits], generator= or noise= [..., 2, frame_len + nfft -
    1]) -> MimoChainResult with the BER of each stream, the phasors and
    the channel estimate.  TX, the 2x2 channel ``mimo2_taps(channel)``
    with its output zero-padded to frame_len + nfft - 1 samples (the SISO
    chain's ``max_impulse = nfft``; the JAX chain cuts it at frame_len +
    taps - 1 and searches as many trials, reading its last sample again
    past the end), AWGN at the config's SNR over each frame's mean TX
    power, RX; on the CUDA device unless ``device`` says otherwise.  The
    step runs eagerly, its stages in spans (module docstring)."""
    _check(cfg)
    return _make_chain(cfg, channel, device, tx_frame_mimo,
                       rx_frame_mimo)


def make_stcode_chain(cfg: OFDMConfig, channel: str = "Fading",
                      device=None):
    """The 2x2 Alamouti loopback (``mimo.py:make_stcode_chain``):
    step(bits [..., num_bits], generator= or noise=) -> MimoChainResult, as
    :func:`make_mimo_chain`."""
    _check_stc(cfg)
    return _make_chain(cfg, channel, device, tx_frame_stcode,
                       rx_frame_stcode)
