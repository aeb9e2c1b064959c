"""NumPy oracle for the QAM extension path (BASELINE.json configs 2-4).

The port's own copy of ``lte_gnu_radio_code_tpu/reference_cpu/qam.py``
(the port imports nothing of the JAX package), on the port's
``utils/params.py`` and ``reference_cpu/golden.py``; the two give the same
arrays bit for bit.  The reference itself is BPSK/QPSK-only
(MultiAntennaSystem.py:156-178 maps only those constellations; golden.py
stops there deliberately), so the 16/64-QAM generalisation is specified by
BASELINE.json.  This module is an independent NumPy implementation of the
QAM mapping, the unbiased-MMSE demap gain and the max-log LLR, plus a full
QAM RX/chain built on the literal golden.py sync/chan-est/EQ stages: the
same-buffer cross-check of the port's QAM demap path
(ops/modulation.bits_to_symbols + maxlog_llr + ops/sync.demap_unbias_gain).

Kept OUT of golden.py so that module stays reference-verbatim.

Independence notes (so agreement is evidence, not tautology):
  * the Gray-PAM levels are derived here by per-pattern binary-reflected
    Gray DECODE (cumulative XOR over the bit pattern), where
    ops/modulation.py builds the inverse permutation of the Gray ENCODE of
    all level indices at once;
  * the max-log LLR is a brute-force min over the constellation per bit
    hypothesis in float64, where the port's path uses masked vectorised mins
    in float32.
"""

from __future__ import annotations

import numpy as np

from ..utils.params import OFDMConfig, used_bins
from . import golden

BITS_PER_SYMBOL = {"BPSK": 1, "QPSK": 2, "QAM16": 4, "QAM64": 6}


def gray_pam(bits_per_axis: int) -> np.ndarray:
    """PAM amplitude for every ``bits_per_axis``-bit Gray pattern (index =
    the MSB-first bit pattern read as binary), unit average power per
    COMPLEX symbol (i.e. each axis carries power 1/2)."""
    m = 1 << bits_per_axis
    amp = np.empty(m)
    for pattern in range(m):
        # binary-reflected Gray decode: b_i = g_i XOR b_{i-1}
        level, b = 0, 0
        for shift in range(bits_per_axis - 1, -1, -1):
            b ^= (pattern >> shift) & 1
            level = (level << 1) | b
        amp[pattern] = 2 * level - (m - 1)
    return amp / np.sqrt(2.0 * (m * m - 1) / 3.0)


def qam_map(bits: np.ndarray, modulation: str) -> np.ndarray:
    """MSB-first bit groups -> Gray square-QAM points (I bits first, then Q)."""
    bps = BITS_PER_SYMBOL[modulation]
    k = bps // 2
    pam = gray_pam(k)
    b = np.asarray(bits).reshape(-1, bps)
    w = 2 ** np.arange(k - 1, -1, -1)
    return pam[b[:, :k] @ w] + 1j * pam[b[:, k:] @ w]


def constellation(modulation: str) -> tuple[np.ndarray, np.ndarray]:
    """(points [M] complex, bit table [M, bps] MSB-first)."""
    bps = BITS_PER_SYMBOL[modulation]
    m = 1 << bps
    idx = np.arange(m)
    bit_tbl = ((idx[:, None] >> np.arange(bps - 1, -1, -1)) & 1).astype(int)
    if modulation == "QPSK":
        pts = golden.qpsk_map(bit_tbl.ravel())
    elif modulation == "BPSK":
        pts = golden.bpsk_map(bit_tbl.ravel())
    else:
        pts = qam_map(bit_tbl.ravel(), modulation)
    return pts, bit_tbl


def maxlog_llr(phasors: np.ndarray, modulation: str, noise_var: float):
    """Brute-force max-log LLRs, float64.  Returns (hard [n*bps], llr) with
    llr > 0 meaning bit = 1 (the ops/modulation.maxlog_llr convention)."""
    pts, bit_tbl = constellation(modulation)
    bps = bit_tbl.shape[1]
    d = np.asarray(phasors).ravel()
    dist = np.abs(d[:, None] - pts[None, :]) ** 2            # [n, M]
    llr = np.empty((d.size, bps))
    for b in range(bps):
        is1 = bit_tbl[:, b] == 1
        llr[:, b] = (dist[:, ~is1].min(axis=1) -
                     dist[:, is1].min(axis=1)) / noise_var
    llr = llr.ravel()
    return (llr > 0).astype(int), llr


def demap_unbias_gain(chan: np.ndarray, snr_lin: float) -> np.ndarray:
    """Inverse of the MMSE amplitude bias |H|^2/(|H|^2 + 1/SNR) — the real
    per-bin gain the port's path applies before an amplitude-decided QAM grid
    decision (ops/sync.py demap_unbias_gain)."""
    h2 = np.abs(np.asarray(chan)) ** 2
    return (h2 + 1.0 / snr_lin) / np.maximum(h2, 1e-30)


def tx_frame(cfg: OFDMConfig, bits: np.ndarray) -> np.ndarray:
    """golden.tx_frame generalised to any supported modulation.

    Identical grid placement, ZC handling and two-stage per-symbol
    normalisation (MultiAntennaSystem.py:113-218); only the bits->points map
    differs.  pilot_grid carving is out of scope here (the QAM oracle tests
    run the non-pilot path, like test_qam_matches_closed_form)."""
    assert cfg.pilot_grid == "none", "QAM oracle covers the non-pilot path"
    if cfg.modulation in ("BPSK", "QPSK"):
        return golden.tx_frame(cfg, bits)
    nfft, cp = cfg.nfft, cfg.cp_len
    _, synch_bins_p = used_bins(nfft, cfg.num_synch_bins)
    _, data_bins_p = used_bins(nfft, cfg.num_data_bins)
    zc = golden.zc_for_config(cfg)
    pattern = cfg.symbol_pattern()
    bits = np.asarray(bits).ravel()
    assert bits.size == cfg.num_bits, (bits.size, cfg.num_bits)
    bpb = cfg.bits_per_bin

    grid = np.zeros((cfg.num_ofdm_symb, nfft), dtype=complex)
    loop_data = 0
    synch_state = 0
    for symb, kind in enumerate(pattern):
        if kind == 0:
            seg = cfg.num_synch_bins
            grid[symb, list(synch_bins_p)] = \
                zc[synch_state * seg:(synch_state + 1) * seg]
            synch_state = (synch_state + 1) % cfg.m_synch
        else:
            nb = cfg.num_data_bins * bpb
            chunk = bits[loop_data * nb:(loop_data + 1) * nb]
            grid[symb, list(data_bins_p)] = qam_map(chunk, cfg.modulation)
            loop_data += 1

    out = np.zeros(cfg.frame_len, dtype=complex)
    min_pow = 1e-30
    for symb in range(cfg.num_ofdm_symb):
        data_ifft = np.fft.ifft(grid[symb], nfft)
        data_time = np.concatenate((data_ifft[-cp:], data_ifft))
        sig_energy = abs(np.dot(data_time, np.conj(data_time).T))
        scale = np.sqrt(len(data_time) / sig_energy) \
            if sig_energy > min_pow else 1.0
        data_time = data_time * scale
        p = np.var(data_time)
        out[symb * cfg.rx_b_len:(symb + 1) * cfg.rx_b_len] = \
            data_time / np.sqrt(p)
    return out


def rx_frame(cfg: OFDMConfig, in0: np.ndarray, perfect_chan_est: bool = False,
             genie_h: np.ndarray | None = None):
    """Full QAM RX: golden.rx_frame's literal sync + chan-est + MMSE EQ,
    then the unbiased-amplitude max-log demap (the models/rxofdm.py QAM
    branch, :111-119).  Returns a dict incl. hard_bits [num_bits]."""
    phasors, tsr, chan_est_tim = golden.rx_frame(
        cfg, in0, perfect_chan_est=perfect_chan_est, genie_h=genie_h)
    # golden.rx_frame keeps only the time CIR; its frequency response is the
    # exact chan_est_freq_p up to f64 FFT round-trip error (~1e-16 rel)
    chan_freq = np.fft.fft(chan_est_tim, cfg.nfft)
    _, data_bins_p = used_bins(cfg.nfft, cfg.num_data_bins)
    h_data = chan_freq[list(data_bins_p)]
    unbiased = phasors * demap_unbias_gain(h_data, cfg.snr_linear)[None, :]
    hard, llr = maxlog_llr(unbiased, cfg.modulation, 1.0 / cfg.snr_linear)
    return dict(phasors=phasors, unbiased=unbiased, time_synch_ref=tsr,
                chan_est_time=chan_est_tim, hard_bits=hard, llr=llr)


def run_chain(cfg: OFDMConfig, bits: np.ndarray | None = None, seed: int = 0):
    """bits -> QAM TX -> channel -> AWGN -> QAM RX.  Mirrors
    golden.run_chain; the port's comparison point is models/chain.make_chain
    with the same config."""
    rng = np.random.default_rng(seed)
    if bits is None:
        bits = rng.integers(0, 2, cfg.num_bits)
    tx = tx_frame(cfg, bits)
    h = golden.channel_taps(cfg.channel if cfg.channel != "AWGN" else "Ideal")
    rx_clean = golden.apply_channel(tx, h)
    sig_pow = np.var(tx)
    rx = golden.awgn(cfg, rx_clean, rng, sig_pow)
    r = rx_frame(cfg, rx)
    hard = r["hard_bits"]
    nb = min(hard.size, np.asarray(bits).size)
    ber = float(np.mean(hard[:nb] != np.asarray(bits).ravel()[:nb]))
    return dict(bits=np.asarray(bits).ravel(), tx=tx, rx=rx, ber=ber, **r)
