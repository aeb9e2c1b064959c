"""The reference's whole-array forms: the semantics of ``golden.py``'s
``tx_frame``, ``apply_channel``, ``awgn``, ``rx_frame`` and ``rx_stream``
over NumPy arrays, in float64, so that a check runs in seconds where the
literal loops take minutes.  ``tests/test_ofdm_bench_reference.py`` holds
each to its literal form.

Every function takes an :class:`Arith`: ``FLOAT64`` is the reference, and
``TF32`` the control, the same computation one precision below the
program's (float32 with TF32 off): every operand of a transform or product
rounded to TF32's 10-bit mantissa, everything in complex64.

Two rules the literal oracle leaves open are fixed here, both read from
the receiver semantics (``models/rxofdm.py`` and ``runtime/stream.py`` of
the program state the same):

* A data window that reaches past the buffer has no defined value: its
  row is marked ``in_buf`` False, and a check compares only rows inside.
* A decision whose own margin is below ``tie`` is ambiguous: where the
  program took the other side of it, the reference follows the program's
  choice (``follow``) and computes everything downstream from it, so a
  rounding at a threshold is not taken for a fault, and no decision
  farther than ``tie`` from its threshold is.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import golden
from .numerology import RefConfig, used_bins


@dataclasses.dataclass(frozen=True)
class Arith:
    """How the reference computes: ``tf32`` rounds each operand of a
    transform or product to a 10-bit mantissa, in complex64."""
    name: str

    @property
    def dtype(self):
        return np.complex128 if self.name == "float64" else np.complex64

    def q(self, x):
        x = np.asarray(x, self.dtype)
        if self.name == "float64":
            return x
        return (_tf32(x.real) + 1j * _tf32(x.imag)).astype(np.complex64)


def _tf32(a: np.ndarray) -> np.ndarray:
    """float32 rounded to nearest even at TF32's 10 mantissa bits."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    u = (u + np.uint32(0x0FFF) + ((u >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return u.view(np.float32)


FLOAT64 = Arith("float64")
TF32 = Arith("tf32")


def _bins(cfg: RefConfig, n: int) -> np.ndarray:
    return np.asarray(used_bins(cfg.nfft, n)[1])


def _del_mat_exp(cfg: RefConfig) -> np.ndarray:
    """[cp+1, m_synch*L] exp(+j 2 pi d b / N), the oracle's delay matrix."""
    return np.tile(np.exp((1j * 2.0 * np.pi / cfg.nfft) * np.outer(
        np.arange(cfg.cp_len + 1), _bins(cfg, cfg.num_synch_bins))),
        (1, cfg.m_synch))


# -- TX, channel, noise -------------------------------------------------------

def tx_frames(cfg: RefConfig, bits: np.ndarray, ar: Arith = FLOAT64
              ) -> np.ndarray:
    """bits [F, num_bits] -> [F, frame_len]: ``golden.tx_frame`` of each."""
    if cfg.modulation != "QPSK":
        raise ValueError("the reference TX maps QPSK only")
    f = bits.shape[0]
    nfft, cp, nb = cfg.nfft, cfg.cp_len, cfg.num_data_bins
    grid = np.zeros((f, cfg.num_ofdm_symb, nfft), complex)
    zc = golden.zc_for_config(cfg)
    pts = golden.QPSK_POINTS[2 * bits[:, 0::2] + bits[:, 1::2]].reshape(
        f, cfg.num_data_symb, nb)
    kinds = np.asarray(cfg.symbol_pattern())
    synch_rows = np.flatnonzero(kinds == 0)
    seg = cfg.num_synch_bins
    sb, db = _bins(cfg, seg), _bins(cfg, nb)
    for j, row in enumerate(synch_rows):
        m = j % cfg.m_synch
        grid[:, row, sb] = zc[m * seg:(m + 1) * seg]
    grid[:, np.flatnonzero(kinds == 1)[:, None], db] = pts
    t = np.fft.ifft(ar.q(grid), nfft, axis=-1)
    t = np.concatenate([t[..., -cp:], t], -1)
    energy = (np.abs(t) ** 2).sum(-1, keepdims=True)
    safe = np.where(energy > 1e-30, energy, 1.0)
    t = t * np.where(energy > 1e-30, np.sqrt(t.shape[-1] / safe), 1.0)
    p = np.var(t, axis=-1, keepdims=True)
    return (t / np.sqrt(p)).reshape(f, cfg.frame_len).astype(ar.dtype)


def channel_frames(cfg: RefConfig, tx: np.ndarray, h: np.ndarray,
                   ar: Arith = FLOAT64) -> np.ndarray:
    """tx [F, L] (*) h, h zero-padded to nfft taps -> [F, L + nfft - 1]
    (``golden.apply_channel`` with ``max_impulse=nfft``)."""
    tx = ar.q(tx)
    h = ar.q(h)
    y = np.zeros((tx.shape[0], tx.shape[1] + max(cfg.nfft, len(h)) - 1),
                 ar.dtype)
    for k, tap in enumerate(h):
        y[:, k:k + tx.shape[1]] += tap * tx
    return y


def noise_power(cfg: RefConfig, sig_pow) -> np.ndarray:
    """``golden.awgn``'s noise variance for a TX power."""
    sig_pow = np.asarray(sig_pow, np.float64)
    if cfg.snr_type == "Digital":
        bits_per_symb = cfg.num_data_bins * cfg.bits_per_bin
        return ((1.0 / bits_per_symb) * cfg.rx_b_len * sig_pow *
                10 ** (-cfg.snr_db / 10))
    return sig_pow * 10 ** (-cfg.snr_db / 10)


def received(cfg: RefConfig, bits: np.ndarray, noise: np.ndarray,
             ar: Arith = FLOAT64) -> np.ndarray:
    """bits [F, num_bits] and unit noise [F, frame_len + nfft - 1] (real
    and imaginary parts N(0, 1)) -> the received frames: TX, the config's
    channel and ``golden.awgn`` with this noise, each frame's TX power its
    ``np.var``."""
    tx = tx_frames(cfg, bits, ar)
    h = golden.channel_taps(cfg.channel if cfg.channel != "AWGN"
                            else "Ideal")
    clean = channel_frames(cfg, tx, h, ar)
    nv = noise_power(cfg, np.var(tx, axis=-1))
    return (clean + np.sqrt(nv / 2.0)[:, None] * ar.q(noise)).astype(
        ar.dtype)


# -- the sync search ----------------------------------------------------------

def search(cfg: RefConfig, x: np.ndarray, n_trials: int,
           ar: Arith = FLOAT64) -> tuple[np.ndarray, np.ndarray]:
    """x [n] -> (|corr| [n_trials, cp+1], power-normalised synch spectra
    [n_trials, m_synch*L]) of the trials at cp + stride * i: the oracle's
    ``del_mat_exp @ (synchdat * conj(zc))``, the product taken as one
    inverse FFT of the spectrum scattered to the synch bins (the same sum)."""
    nfft, m0, seg = cfg.nfft, cfg.m_synch, cfg.num_synch_bins
    starts = cfg.cp_len + cfg.stride * np.arange(n_trials)
    idx = (starts[:, None, None] + (np.arange(m0) * cfg.rx_b_len)[:, None] +
           np.arange(nfft))
    spec = np.fft.fft(ar.q(x[idx]), nfft, axis=-1)[..., _bins(cfg, seg)]
    spec = spec.reshape(n_trials, m0 * seg)
    spec = spec * np.sqrt(spec.shape[-1] /
                          (np.abs(spec) ** 2).sum(-1, keepdims=True))
    q = (ar.q(spec) * np.conj(golden.zc_for_config(cfg))).reshape(
        n_trials, m0, seg).sum(1)
    y = np.zeros((n_trials, nfft), ar.dtype)
    y[:, _bins(cfg, seg)] = q
    corr = nfft * np.fft.ifft(ar.q(y), nfft, axis=-1)[:, :cfg.cp_len + 1]
    return np.abs(corr), spec.astype(ar.dtype)


def gate(cfg: RefConfig) -> float:
    return cfg.detection_gate * cfg.m_synch * cfg.num_synch_bins


def estimate(cfg: RefConfig, spec: np.ndarray, delay: int,
             ar: Arith = FLOAT64) -> np.ndarray:
    """One lock's channel [nfft] from its trial spectrum and delay (the
    oracle's ``data_recov`` ... ``chan_est1``)."""
    tmp = (_del_mat_exp(cfg)[delay] * ar.q(spec) *
           np.conj(golden.zc_for_config(cfg))) / (1.0 / cfg.snr_linear + 1.0)
    full = np.zeros(cfg.nfft, ar.dtype)
    full[_bins(cfg, cfg.num_synch_bins)] = tmp.reshape(
        cfg.m_synch, cfg.num_synch_bins).mean(0)
    return full


def demod(cfg: RefConfig, x: np.ndarray, starts: np.ndarray, delay: int,
          chan: np.ndarray, ar: Arith = FLOAT64):
    """The data windows at ``starts`` demodulated with one lock's channel
    and delay: (phasors [len(starts), num_data_bins], in_buf [len(starts)]
    True where the whole window lies in x)."""
    nfft, nb = cfg.nfft, cfg.num_data_bins
    db = _bins(cfg, nb)
    in_buf = starts + nfft <= len(x)
    idx = np.minimum(np.where(in_buf, starts, 0)[:, None] + np.arange(nfft),
                     len(x) - 1)
    f = np.fft.fft(ar.q(x[idx]), nfft, axis=-1)[:, db]
    f = f * np.sqrt(nb / (np.abs(f) ** 2).sum(-1, keepdims=True))
    rot = np.exp((1j * 2.0 * np.pi / nfft) * delay * db)
    h = chan[db]
    eq = np.conj(h) / (1.0 / cfg.snr_linear + h * np.conj(h))
    ph = ar.q(eq) * ar.q(f * rot)
    return np.where(in_buf[:, None], ph, 0).astype(ar.dtype), in_buf


def _decide(cfg, corr, dmax, crossing, lo, want, tie):
    """The first trial from index ``lo`` on whose peak ``dmax`` crosses the
    gate (``crossing``: the sorted indices of every such trial), or the
    program's ``want`` = (trial, delay) where that is a choice within
    ``tie`` of the reference's: every trial before it at most gate + tie,
    its own peak above gate - tie, its delay's |corr| within tie of its
    best.  Returns (trial or None, delay, followed)."""
    g = gate(cfg)
    k = int(np.searchsorted(crossing, lo))
    own = int(crossing[k]) if k < len(crossing) else None
    if want is not None:
        t, d = want
        if (lo <= t < len(dmax) and 0 <= d < corr.shape[-1] and
                (dmax[lo:t] <= g + tie).all() and dmax[t] > g - tie and
                corr[t, d] >= dmax[t] - tie and
                (t != own or d != int(corr[t].argmax()))):
            return t, d, True
    if own is None:
        return None, 0, False
    return own, int(corr[own].argmax()), False


# -- the single-lock frame RX ---------------------------------------------------

def n_trials_frame(cfg: RefConfig, n: int) -> int:
    """The trials ``golden.rx_frame`` evaluates in an n-sample buffer."""
    need = cfg.m_synch * cfg.rx_b_len + cfg.nfft + cfg.cp_len
    return max(0, (n - need - 1) // cfg.stride + 1)


def data_starts(cfg: RefConfig, ptr: int, n: int) -> np.ndarray:
    """Start of each data symbol of a frame locked at ptr, in the order of
    ``golden.rx_frame``'s pruned rows."""
    n_unique = n // cfg.rx_b_len
    blocks = np.arange(n_unique)[::cfg.pattern_len]
    rows = (ptr + cfg.m_synch * cfg.rx_b_len * (blocks[:, None] + 1) +
            cfg.rx_b_len * np.arange(cfg.synch_dat[1])[None, :])
    return rows.reshape(-1)[:cfg.num_data_symb]


def rx_frame(cfg: RefConfig, x: np.ndarray, ar: Arith = FLOAT64,
             follow=None, tie: float = 0.0) -> dict:
    """``golden.rx_frame`` of one buffer, plus the QPSK hard bits of
    ``golden.bit_recovery``: found, lock_ptr, delay_idx, phasors
    [num_data_symb, num_data_bins], in_buf, hard_bits [num_bits] and
    whether it followed the program's (lock_ptr, delay_idx) ``follow``."""
    n_trials = n_trials_frame(cfg, len(x))
    corr, spec = search(cfg, x, n_trials, ar)
    want = None
    if follow is not None:
        want = ((follow[0] - cfg.cp_len) // cfg.stride, follow[1])
    dmax = corr.max(-1)
    t, d, followed = _decide(cfg, corr, dmax, np.flatnonzero(dmax > gate(cfg)),
                             0, want, tie)
    out = dict(found=t is not None, followed=followed)
    if t is None:
        return out
    ptr = cfg.cp_len + cfg.stride * t
    chan = estimate(cfg, spec[t], d, ar)
    ph, in_buf = demod(cfg, x, data_starts(cfg, ptr, len(x)), d, chan, ar)
    hard, _, _ = golden.bit_recovery(ph)
    out.update(lock_ptr=ptr, delay_idx=d, phasors=ph, in_buf=in_buf,
               hard_bits=hard, dmax=float(corr[t].max()))
    return out


# -- the continuous multi-detection RX ----------------------------------------

def stream_detections(cfg: RefConfig, x: np.ndarray, lo: int, hi: int,
                      ar: Arith = FLOAT64, follow=None,
                      tie: float = 0.0) -> dict:
    """``golden.rx_stream`` over a stream segment x, from an empty table
    at x's first trial: every gate crossing more than 2 cp + nfft after the
    last accepted one is a detection with its own channel and block demod.
    Reports the detections whose pointers (relative to x[0]) lie in
    [lo, hi), in order; ``follow`` lists the program's (ptr, delay) there,
    and the scan takes each of them that is a choice within ``tie``.
    Returns ptrs, delays, chans [k, nfft], phasors [k, nd, num_data_bins],
    demod_ok, hard_bits [k, nd, 2 num_data_bins] and the count followed."""
    nfft, cp, stride = cfg.nfft, cfg.cp_len, cfg.stride
    nd = cfg.synch_dat[1]
    refractory = 2 * cp + nfft
    n_trials = max(0, (len(x) - (cfg.m_synch * cfg.rx_b_len + nfft + cp) -
                       1) // stride + 1)
    corr, spec = search(cfg, x, n_trials, ar)
    dmax = corr.max(-1)
    crossing = np.flatnonzero(dmax > gate(cfg))
    follow = list(follow or [])
    ptrs, delays, followed = [], [], 0
    start = 0
    while start < n_trials:
        want = None
        if follow:
            fp, fd = follow[0]
            want = ((fp - cp) // stride, fd)
        t, d, took = _decide(cfg, corr, dmax, crossing, start, want, tie)
        if t is None:
            break
        ptr = cp + stride * t
        if lo <= ptr < hi:
            if follow:
                follow.pop(0)
            ptrs.append(ptr)
            delays.append(d)
            followed += took
        elif ptr >= hi:
            break
        start = t + refractory // stride + 1
    k = len(ptrs)
    chans = np.zeros((k, nfft), ar.dtype)
    phasors = np.zeros((k, nd, cfg.num_data_bins), ar.dtype)
    demod_ok = np.zeros(k, bool)
    for i, (p, d) in enumerate(zip(ptrs, delays)):
        chans[i] = estimate(cfg, spec[(p - cp) // stride], d, ar)
        first = p + cfg.m_synch * cfg.rx_b_len
        ph, in_buf = demod(cfg, x, first + cfg.rx_b_len * np.arange(nd), d,
                           chans[i], ar)
        phasors[i] = ph
        demod_ok[i] = in_buf.all()
    hard = golden.bit_recovery(phasors)[0].reshape(k, nd, -1)
    return dict(ptrs=np.asarray(ptrs, np.int64),
                delays=np.asarray(delays, np.int64), chans=chans,
                phasors=phasors, demod_ok=demod_ok, hard_bits=hard,
                followed=followed)
