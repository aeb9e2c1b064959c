"""The plain reference of the 2x2 spatial-multiplexing (SpMult) link, one
frame at a time: a frozen copy of the port's
``lte_gnu_radio_code_tpu_torch/reference_cpu/mimo.py``, kept here so that
the benchmark's reference loads nothing of the program.  It runs on
``reference/numerology.py``'s ``RefConfig`` and ``reference/golden.py``;
the code is the port's, unchanged: plain torch in float64 (complex128),
TF32 off.

Notation: N = nfft, C = cp_len, R = N + C, L = num_synch_bins, B the data
bins, nd = synch_dat[1], a pattern = two synch symbols then nd data
symbols, s the search stride, b a bin's wrapped FFT index.

TX, antenna a in {0, 1} (``MultiAntennaSystem.multi_ant_binary_map`` and
``multi_ant_symb_gen`` with the two streams of TS 36.211 section 6.3.3.2's
two-layer mapping, one layer an antenna, the identity precoder):
  grid_a[row, synch bins] = z_a  on the a-th synch row of each pattern
                            (z = ZC(2L); z_a = z[a L:(a + 1) L]), 0 on
                            the other synch row;
  grid_a[data rows, B]    = QPSK(bits_a) (``golden.QPSK_POINTS``, MSB
                            first), row-major in (data symbol, bin);
  t_a[row] = CP(ifft_N(grid_a[row])) * sqrt(R / E_row), E_row =
             sum |CP(ifft_N(grid_a[row]))|^2, and 0 where E_row is 0.
Channel (``MultiAntennaSystem.py:69-74``): h[r, t] the 2x2 five-tap CIRs,
each pair at unit norm; y_r = sum_t h[r, t] (*) t_t, full length, zero-
padded to frame_len + N - 1 samples.
AWGN: P = mean |t|^2 over both antennas and every sample; y += sqrt(nv / 2)
w with the given unit noise w (real and imaginary parts N(0, 1)) and nv =
R P 10^(-snr_db / 10) / (|B| bits_per_bin) (``golden.awgn``, "Digital").
Search, on RX antenna 0 against z_0 alone (one synch symbol a trial):
  trial p at C + s p, p < (n - (R + N + C) - 1) // s + 1;
  S_p = fft_N(y_0[C + s p:][:N])[synch bins], scaled to sum |S_p|^2 = L;
  corr[p, d] = |sum_b S_p[b] conj(z_0[b]) exp(+j 2 pi d b / N)|, d <= C.
Lock: the first trial whose peak max_d corr[p, d] exceeds detection_gate
L; ptr = C + s p, delay = its argmax (the lowest of equal ones); with no
crossing, found is False and trial 0 is taken.
Windows: a window of N samples at start; an index past the buffer's end
reads its last sample (the receiver's edge rule).
2x2 LS estimate, from the two pilot windows at ptr + t R (t = 0, 1) on both
RX antennas, rot[b] = exp(+j 2 pi delay b / N):
  H[r, t, b] = fft_N(y_r[ptr + t R:][:N])[b] rot[b] conj(z_t[b]),
  then H *= sqrt(4 L / sum |H|^2), one common scale.
Data: Y[r, k, b] = fft_N(y_r[window of data symbol k])[b] rot[b], the
data symbols in pattern order.
LMMSE, per data bin b, with snr = 10^(snr_db / 20):
  W_b = (H_b^H H_b + I / snr)^-1 H_b^H,  x[:, k, b] = W_b Y[:, k, b],
then each stream scaled to unit mean power over its (k, b).
Hard bits: ``golden.bit_recovery`` of each stream (the reference's QPSK
decision: a rail's bit flips at 0 and at +-sqrt(2)).

Departures from a published receiver: the pilots are the reference's own
time-orthogonal ZC symbols, not LTE's cell-specific reference signals; the
channel is the reference's 2x2 CIR; the frame is the reference's (2, nd)
pattern; the detector is the port's LMMSE.  The upstream receiver exits
with "not supported" for SpMult, so this file is the reference of record.

``Arith``: ``FLOAT64`` is the reference; ``TF32`` the same computation
one precision below the port's float32 (TF32 off): every operand of a
transform or product rounded to TF32's 10-bit mantissa, in complex64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import golden


@dataclasses.dataclass(frozen=True)
class Arith:
    """How the reference computes: ``tf32`` rounds each operand of a
    transform or product to a 10-bit mantissa, in complex64."""
    name: str

    @property
    def dtype(self):
        return torch.complex128 if self.name == "float64" else torch.complex64

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x).to(self.dtype)
        if self.name == "float64":
            return x
        return torch.complex(_tf32(x.real), _tf32(x.imag))


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest even at TF32's 10 mantissa bits."""
    u = a.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    u = u & 0xFFFFFFFF
    u = (u + 0x0FFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


FLOAT64 = Arith("float64")
TF32 = Arith("tf32")


def _bins(nfft: int, num_bins: int) -> torch.Tensor:
    """Wrapped FFT indices of the used bins (no DC, no Nyquist)."""
    half = num_bins // 2
    signed = list(range(-half, 0)) + list(range(1, half + 1))
    return torch.tensor([(nfft + b) % nfft for b in signed])


def mimo2_taps(name: str = "Fading") -> torch.Tensor:
    """[2, 2, 5] complex128 CIRs [rx, tx, tap] (``MultiAntennaSystem.py:
    69-74``), each pair scaled to unit norm; "Ideal" the all-ones one-tap
    matrix."""
    h = torch.zeros(2, 2, 5, dtype=torch.complex128)
    h[0, 0] = torch.tensor([0.3977, 0.7954 - 0.3977j, -0.1988, 0.0994,
                            -0.0398])
    h[0, 1, :2] = torch.tensor([0.8423j, 0.5391])
    h[1, 0, :3] = torch.tensor([0.1631, -0.0815 + 0.9784j, 0.0978])
    h[1, 1, :4] = torch.tensor([0.0572j, 0.3659j, 0.5717 - 0.5717j, 0.4574])
    if name == "Ideal":
        h.zero_()
        h[:, :, 0] = 1
    return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)


def _zc(cfg) -> torch.Tensor:
    """[2, L]: z_0 and z_1, the two halves of the pattern's ZC sequence."""
    return torch.from_numpy(golden.zc_for_config(cfg)).reshape(
        2, cfg.num_synch_bins)


def num_patterns(cfg, n: int) -> int:
    """The patterns a buffer of n samples demodulates: every pattern of
    the frame whose windows fit after a lock at the first trial."""
    block = cfg.pattern_len * cfg.rx_b_len
    avail = n - cfg.cp_len - (cfg.pattern_len - 1) * cfg.rx_b_len - cfg.nfft
    return max(0, min(cfg.num_patterns, avail // block + 1))


def n_trials(cfg, n: int) -> int:
    """The search's trials in a buffer of n samples (one synch symbol a
    trial)."""
    need = cfg.rx_b_len + cfg.nfft + cfg.cp_len
    return max(0, (n - need - 1) // cfg.stride + 1)


def gate(cfg) -> float:
    return cfg.detection_gate * cfg.num_synch_bins


# -- TX, channel, noise -------------------------------------------------------

def tx_frame(cfg, bits, ar: Arith = FLOAT64) -> torch.Tensor:
    """bits [2, num_bits] -> [2, frame_len]: each antenna's frame."""
    if cfg.m_synch != 2 or cfg.modulation != "QPSK":
        raise ValueError("the 2x2 reference maps QPSK with synch_dat (2, nd)")
    nfft, cp, nb = cfg.nfft, cfg.cp_len, cfg.num_data_bins
    bits = torch.as_tensor(np.asarray(bits)).to(torch.int64)
    pts = torch.from_numpy(golden.QPSK_POINTS)[2 * bits[:, 0::2] +
                                               bits[:, 1::2]]
    kinds = torch.tensor(cfg.symbol_pattern())
    synch_rows = torch.nonzero(kinds == 0)[:, 0]
    data_rows = torch.nonzero(kinds == 1)[:, 0]
    grid = torch.zeros(2, cfg.num_ofdm_symb, nfft, dtype=torch.complex128)
    zc = _zc(cfg)
    sb, db = _bins(nfft, cfg.num_synch_bins), _bins(nfft, nb)
    for ant in range(2):
        for row in synch_rows[ant::2]:
            grid[ant, row, sb] = zc[ant]
        grid[ant, data_rows[:, None], db] = pts[ant].reshape(-1, nb)
    t = torch.fft.ifft(ar.q(grid), nfft, dim=-1)
    t = torch.cat([t[..., -cp:], t], -1)
    energy = (t.abs() ** 2).sum(-1, keepdim=True)
    scale = torch.where(energy > 0, torch.sqrt(
        (nfft + cp) / torch.where(energy > 0, energy, 1.0)), 0.0)
    return (t * scale).reshape(2, cfg.frame_len).to(ar.dtype)


def channel(cfg, tx: torch.Tensor, h: torch.Tensor,
            ar: Arith = FLOAT64) -> torch.Tensor:
    """tx [2, T] through h [2, 2, taps] -> [2, T + nfft - 1]: each RX
    antenna's sum over the TX antennas of the full convolution."""
    tx, h = ar.q(tx), ar.q(h)
    y = torch.zeros(2, tx.shape[-1] + max(cfg.nfft, h.shape[-1]) - 1,
                    dtype=ar.dtype)
    for k in range(h.shape[-1]):
        y[:, k:k + tx.shape[-1]] += h[:, :, k] @ tx
    return y


def noise_power(cfg, sig_pow: float) -> float:
    """``golden.awgn``'s noise variance for a TX power ("Digital")."""
    if cfg.snr_type != "Digital":
        return sig_pow * 10 ** (-cfg.snr_db / 10)
    return (cfg.rx_b_len * sig_pow * 10 ** (-cfg.snr_db / 10) /
            (cfg.num_data_bins * cfg.bits_per_bin))


def received(cfg, bits, noise, ar: Arith = FLOAT64,
             chan: str = "Fading") -> torch.Tensor:
    """bits [2, num_bits] and unit noise [2, frame_len + nfft - 1] -> the
    two RX antennas' samples."""
    tx = tx_frame(cfg, bits, ar)
    clean = channel(cfg, tx, mimo2_taps(chan), ar)
    nv = noise_power(cfg, float((tx.abs() ** 2).mean()))
    return clean + float(np.sqrt(nv / 2.0)) * ar.q(
        torch.as_tensor(np.asarray(noise)))


# -- RX ----------------------------------------------------------------------

def windows(y: torch.Tensor, start: int, offsets: torch.Tensor
            ) -> torch.Tensor:
    """y[..., start + offsets], an index past the end reading the last
    sample."""
    n = y.shape[-1]
    idx = (min(max(start, 0), n) + offsets).clamp_max(n - 1)
    return y[..., idx]


def search(cfg, y0: torch.Tensor, ar: Arith = FLOAT64) -> torch.Tensor:
    """RX antenna 0's samples [n] -> |corr| [n_trials, cp + 1]."""
    nfft, cp, seg = cfg.nfft, cfg.cp_len, cfg.num_synch_bins
    p = n_trials(cfg, y0.shape[-1])
    starts = cp + cfg.stride * torch.arange(p)
    sb = _bins(nfft, seg)
    spec = torch.fft.fft(ar.q(y0[starts[:, None] + torch.arange(nfft)]),
                         nfft, dim=-1)[:, sb]
    spec = spec * torch.sqrt(seg / (spec.abs() ** 2).sum(-1, keepdim=True))
    q = torch.zeros(p, nfft, dtype=ar.dtype)
    q[:, sb] = ar.q(spec) * _zc(cfg)[0].conj().to(ar.dtype)
    # sum_b q[b] exp(+j 2 pi d b / N) for every d at once: N ifft_N(q)[d]
    return (nfft * torch.fft.ifft(ar.q(q), nfft, dim=-1)[:, :cp + 1]).abs()


def lock(cfg, corr: torch.Tensor, follow=None, tie: float = 0.0):
    """(found, trial, delay, followed): the first trial whose peak crosses
    the gate and its delay; or the program's ``follow`` = (trial, delay)
    where that is a choice within ``tie`` of the reference's: every trial
    before it at most gate + tie, its own peak above gate - tie, its
    delay's |corr| within tie of its peak."""
    g = gate(cfg)
    peak = corr.max(-1).values
    crossing = torch.nonzero(peak > g)[:, 0]
    own = int(crossing[0]) if len(crossing) else None
    if follow is not None:
        t, d = follow
        if (0 <= t < len(peak) and 0 <= d < corr.shape[-1] and
                bool((peak[:t] <= g + tie).all()) and
                float(peak[t]) > g - tie and
                float(corr[t, d]) >= float(peak[t]) - tie and
                (t != own or d != int(corr[t].argmax()))):
            return float(peak[t]) > g, t, d, True
    t = 0 if own is None else own
    return own is not None, t, int(corr[t].argmax()), False


def estimate(cfg, y: torch.Tensor, ptr: int, delay: int,
             ar: Arith = FLOAT64) -> torch.Tensor:
    """The 2x2 LS estimate [rx, tx, nfft], zero off the synch bins."""
    nfft, seg = cfg.nfft, cfg.num_synch_bins
    sb = _bins(nfft, seg)
    off = (torch.arange(2) * cfg.rx_b_len)[:, None] + torch.arange(nfft)
    s = torch.fft.fft(ar.q(windows(y, ptr, off)), nfft, dim=-1)[..., sb]
    rot = torch.exp((2j * np.pi / nfft) * delay * sb.to(torch.float64))
    h = ar.q(s * rot.to(ar.dtype)) * _zc(cfg).conj().to(ar.dtype)
    h = h * torch.sqrt(4 * seg / (h.abs() ** 2).sum())
    full = torch.zeros(2, 2, nfft, dtype=ar.dtype)
    full[..., sb] = h
    return full


def data_offsets(cfg, patterns: int) -> torch.Tensor:
    """[patterns * nd, nfft] offsets of the data windows from the lock."""
    nd = cfg.synch_dat[1]
    block = cfg.pattern_len * cfg.rx_b_len
    first = (torch.arange(patterns)[:, None] * block +
             (cfg.m_synch + torch.arange(nd))[None, :] * cfg.rx_b_len)
    return first.reshape(-1, 1) + torch.arange(cfg.nfft)


def demod(cfg, y: torch.Tensor, ptr: int, delay: int, patterns: int,
          ar: Arith = FLOAT64) -> torch.Tensor:
    """The derotated data bins [rx, patterns * nd, B]."""
    nfft = cfg.nfft
    db = _bins(nfft, cfg.num_data_bins)
    f = torch.fft.fft(ar.q(windows(y, ptr, data_offsets(cfg, patterns))),
                      nfft, dim=-1)[..., db]
    rot = torch.exp((2j * np.pi / nfft) * delay * db.to(torch.float64))
    return ar.q(f) * ar.q(rot)


def detect(cfg, chan: torch.Tensor, fd: torch.Tensor,
           ar: Arith = FLOAT64) -> torch.Tensor:
    """Per-bin LMMSE of both streams, each at unit power: [2, K, B]."""
    hd = ar.q(chan[..., _bins(cfg.nfft, cfg.num_data_bins)].permute(2, 0, 1))
    hh = hd.conj().transpose(-1, -2)                    # [B, tx, rx]
    eye = torch.eye(2, dtype=ar.dtype)
    w = torch.linalg.inv(hh @ hd + eye / cfg.snr_linear) @ hh
    x = torch.einsum("bij,jkb->ikb", ar.q(w), ar.q(fd))
    return x * torch.rsqrt((x.abs() ** 2).mean((-2, -1), keepdim=True))


def hard_bits(phasors: torch.Tensor) -> np.ndarray:
    """[2, K, B] -> [2, 2 K B]: ``golden.bit_recovery``'s decisions of
    each stream."""
    return np.stack([golden.bit_recovery(p.numpy())[0] for p in phasors])


def rx_frame(cfg, y: torch.Tensor, ar: Arith = FLOAT64, follow=None,
             tie: float = 0.0) -> dict:
    """y [2, n] -> found, lock_ptr, delay_idx, followed, chan_freq [2, 2,
    nfft], phasors [2, K, B] and hard_bits [2, num_bits]; ``follow`` the
    program's (lock_ptr, delay_idx), taken where it is a choice within
    ``tie`` (:func:`lock`)."""
    corr = search(cfg, y[0], ar)
    want = None
    if follow is not None:
        want = ((follow[0] - cfg.cp_len) // cfg.stride, follow[1])
    found, t, d, followed = lock(cfg, corr, want, tie)
    ptr = cfg.cp_len + cfg.stride * t
    chan = estimate(cfg, y, ptr, d, ar)
    ph = detect(cfg, chan, demod(cfg, y, ptr, d,
                                 num_patterns(cfg, y.shape[-1]), ar), ar)
    return dict(found=found, lock_ptr=ptr, delay_idx=d, followed=followed,
                chan_freq=chan, phasors=ph, hard_bits=hard_bits(ph))


def link_frame(cfg, bits, noise, ar: Arith = FLOAT64, follow=None,
               tie: float = 0.0, chan: str = "Fading") -> dict:
    """One frame end to end: :func:`rx_frame` of :func:`received` through
    the 2x2 channel ``chan``, with each stream's BER (over the bits its
    decisions cover)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = rx_frame(cfg, received(cfg, bits, noise, ar, chan), ar, follow, tie)
    bits = np.asarray(bits)
    nb = min(bits.shape[-1], r["hard_bits"].shape[-1])
    r["ber"] = (r["hard_bits"][:, :nb] != bits[:, :nb]).mean(-1)
    return r
