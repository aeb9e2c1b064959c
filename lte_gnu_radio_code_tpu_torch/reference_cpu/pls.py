"""CPU oracle for the PLS (physical-layer security) MIMO key-exchange suite.

Literal NumPy replication of TEST/GNU_RADIO_OFFLINE/pls_aio.py (P1) with the
object-arrays flattened to dense [symb, subband, n, n] tensors and the
matplotlib calls removed.  The three-state Alice/Bob protocol
(pls_aio.py:107-141):

  state 0  Alice sends random-unitary-precoded QPSK reference signals
  state 1  Bob estimates the effective channel per subband, SVDs it, sends
           his key bits as DFT-codebook precoders rotated by conj(U_B)
  state 2  Alice SVDs her observation; the right singular vectors ARE the
           (phase-normalised) DFT precoders; min-distance PMI recovers bits

Channel driver replicates topblock.py:21-78 (per-antenna-pair convolution).

The port's own copy of ``lte_gnu_radio_code_tpu/reference_cpu/pls.py`` (the
port imports nothing of the JAX package); the two give the same arrays bit
for bit.  ``ops/pls.py`` takes its constant tables (codebook, synch mask,
reference symbols) from here.  One difference, in a side effect only:
``ref_signal`` draws the reference's ``np.random.seed(250)`` stream from a
``RandomState(250)`` of its own, the same numbers, and leaves the caller's
global numpy state alone.
"""

from __future__ import annotations

import numpy as np

from ..utils.params import PLSConfig


# ---------------------------------------------------------------------------
# Static signal structure
# ---------------------------------------------------------------------------


def codebook(cfg: PLSConfig) -> np.ndarray:
    """[2^bits, n, n] DFT codebook, w = exp(j2pi(n/N)(m + p/2^B))/sqrt(N)
    (pls_aio.py:143-159)."""
    npre = 2 ** cfg.bit_codebook
    n_ant = cfg.num_ant
    out = np.zeros((npre, n_ant, n_ant), dtype=complex)
    for p in range(npre):
        for m in range(n_ant):
            for n in range(n_ant):
                out[p, n, m] = np.exp(1j * 2 * np.pi * (n / n_ant) *
                                      (m + p / npre)) / np.sqrt(n_ant)
    return out


def zadoff_chu(cfg: PLSConfig, prime: int) -> np.ndarray:
    """Length num_synch_bins ZC (pls_aio.py:196-204)."""
    nb = cfg.num_synch_bins
    x0 = np.arange(nb)
    if nb % 2 == 0:
        return np.exp(-1j * (2 * np.pi / nb) * prime * (x0 ** 2 / 2))
    return np.exp(-1j * (2 * np.pi / nb) * prime * (x0 * (x0 + 1)) / 2)


def synch_mask(cfg: PLSConfig) -> np.ndarray:
    """[n_ant, frame_len] time-domain synch mask: per-symbol ZC with prime
    alternation [23, 41], antenna-alternating every 2 synch symbols
    (pls_aio.py:160-193)."""
    primes = list(cfg.zc_primes) * cfg.num_data_symb
    symb_len = cfg.symb_len
    signals = np.zeros((cfg.num_synch_symb, symb_len), dtype=complex)
    bins = np.asarray(cfg.used_synch_bins())
    for s in range(cfg.num_synch_symb):
        freq = np.zeros(cfg.nfft, dtype=complex)
        freq[bins] = zadoff_chu(cfg, primes[s])
        t = np.fft.ifft(freq)
        t = np.concatenate([t[-cfg.cp_len:], t])
        p = np.sum(t * np.conj(t)).real / len(t)
        signals[s] = t / np.sqrt(p)

    mask = np.zeros((cfg.num_ant, cfg.frame_len), dtype=complex)
    sc = 0
    for i, kind in enumerate(cfg.symbol_pattern()):
        if kind == 0:
            mod = sc % (cfg.num_ant * len(cfg.zc_primes))
            ant = 0 if mod in (0, 1) else 1
            mask[ant, i * symb_len:(i + 1) * symb_len] = signals[sc]
            sc += 1
    return mask


def ref_signal(cfg: PLSConfig, legacy_seed: bool = True,
               rng: np.random.Generator | None = None) -> np.ndarray:
    """[S, B] QPSK references exp(j*pi/4*{1,3,5,7}) (pls_aio.py:309-325).

    legacy_seed replicates the reference's np.random.seed(250) draw exactly,
    from a RandomState(250), which yields the same stream.
    """
    if legacy_seed:
        rs = np.random.RandomState(250)
        draw = lambda: rs.choice(np.array([1, 3, 5, 7]))
    else:
        draw = lambda: rng.choice(np.array([1, 3, 5, 7]))
    out = np.zeros((cfg.num_data_symb, cfg.num_data_bins), dtype=complex)
    for s in range(cfg.num_data_symb):
        for b in range(cfg.num_data_bins):
            out[s, b] = np.exp(1j * (np.pi / 4) * draw())
    return out


# ---------------------------------------------------------------------------
# TX machinery
# ---------------------------------------------------------------------------


def unitary_gen(cfg: PLSConfig, rng: np.random.Generator) -> np.ndarray:
    """[S, SB, n, n] random unitaries via QR of uniform(0,1)+j*uniform(0,1)
    with R-diagonal phase fix (pls_aio.py:236-249)."""
    S, SB, n = cfg.num_data_symb, cfg.num_subbands, cfg.num_ant
    out = np.zeros((S, SB, n, n), dtype=complex)
    for s in range(S):
        for sb in range(SB):
            q, r = np.linalg.qr(rng.uniform(0, 1, (n, n)) +
                                1j * rng.uniform(0, 1, (n, n)))
            out[s, sb] = q @ np.diag(np.diag(r) / np.abs(np.diag(r)))
    return out


def bits_to_precoders(cfg: PLSConfig, bits: np.ndarray) -> np.ndarray:
    """key bits -> [S, SB, n, n] DFT precoders (pls_aio.py:251-291)."""
    cb = codebook(cfg)
    S, SB = cfg.num_data_symb, cfg.num_subbands
    bits = np.asarray(bits).reshape(S, SB, cfg.bit_codebook)
    w = 2 ** np.arange(cfg.bit_codebook - 1, -1, -1)
    idx = (bits * w).sum(-1).astype(int)
    return cb[idx]


def rotated_precoder(dft_precoders: np.ndarray,
                     rotation: np.ndarray) -> np.ndarray:
    """conj(U) @ conj(F).T per (symb, subband) (pls_aio.py:293-307)."""
    return np.einsum("ssab,sscb->ssac".replace("ss", "xy"),
                     np.conj(rotation), np.conj(dft_precoders))


def apply_precoders(cfg: PLSConfig, precoders: np.ndarray,
                    ref_sig: np.ndarray) -> np.ndarray:
    """[n_ant, S*B] frequency-bin data: column j of the subband's precoder
    scaled by the bin's reference (pls_aio.py:327-357)."""
    S, B = cfg.num_data_symb, cfg.num_data_bins
    n, sbs = cfg.num_ant, cfg.subband_size
    out = np.zeros((n, S * B), dtype=complex)
    for s in range(S):
        fbin = np.zeros((n, B), dtype=complex)
        for sb in range(cfg.num_subbands):
            fbin[:, sb * sbs:(sb + 1) * sbs] = precoders[s, sb]
        for b in range(B):
            fbin[:, b] *= ref_sig[s, b]
        out[:, s * B:(s + 1) * B] = fbin
    return out


def ofdm_modulate(cfg: PLSConfig, freq_bin_data: np.ndarray,
                  norm: str = "joint") -> np.ndarray:
    """[n_ant, S*symb_len] time symbols + per-symbol normalisation
    (pls_aio.py:359-400).

    ``norm='legacy'`` replicates the reference verbatim, which computes an
    energy scale factor from — and applies it to — antenna 0 only (:385
    ``and ant == 0``).  Any per-antenna scale multiplies the effective
    precoder by diag(s0, s1), and since the CP repeats a signal-dependent
    time slice the two antennas' energies genuinely differ, so even a
    symmetric per-antenna normalisation injects a non-scalar diagonal.
    That breaks SVD reciprocity — Alice's return channel is H^T diag(sB)
    while Bob estimated H diag(sA) — and PMI recovery fails on any
    full-rank channel.  The reference's own demo never notices because
    topblock.py:56-59 uses the rank-1 all-ones channel.

    ``norm='joint'`` (default, the adjudicated fix per SURVEY.md §7.3)
    applies only the reference's *joint* 1/sqrt(sum-of-antenna-variances)
    scalar (:397-398), which preserves the precoder structure exactly."""
    S = cfg.num_data_symb
    bins = np.asarray(cfg.used_data_bins())
    out = np.zeros((cfg.num_ant, S * cfg.symb_len), dtype=complex)
    for s in range(S):
        p = 0.0
        seg = np.zeros((cfg.num_ant, cfg.symb_len), dtype=complex)
        for ant in range(cfg.num_ant):
            sym = np.zeros(cfg.nfft, dtype=complex)
            sym[bins] = freq_bin_data[ant, s * cfg.num_data_bins:
                                      (s + 1) * cfg.num_data_bins]
            t = np.fft.ifft(sym, cfg.nfft)
            t = np.concatenate([t[-cfg.cp_len:], t])
            energy = abs(np.dot(t, np.conj(t).T))
            if norm == "legacy" and energy > 1e-30 and ant == 0:
                t = t * np.sqrt(len(t) / energy)
            p += np.var(t)
            seg[ant] = t
        out[:, s * cfg.symb_len:(s + 1) * cfg.symb_len] = seg / np.sqrt(p)
    return out


def synch_data_mux(cfg: PLSConfig, data_time: np.ndarray) -> np.ndarray:
    """Insert data symbols into the synch mask (pls_aio.py:591-622)."""
    buf = synch_mask(cfg).copy()
    dc = 0
    for i, kind in enumerate(cfg.symbol_pattern()):
        if kind == 1:
            buf[:, i * cfg.symb_len:(i + 1) * cfg.symb_len] = \
                data_time[:, dc * cfg.symb_len:(dc + 1) * cfg.symb_len]
            dc += 1
    return buf


def transmit(cfg: PLSConfig, precoders: np.ndarray, ref_sig: np.ndarray,
             norm: str = "joint") -> np.ndarray:
    fb = apply_precoders(cfg, precoders, ref_sig)
    dt = ofdm_modulate(cfg, fb, norm)
    return synch_data_mux(cfg, dt)


# ---------------------------------------------------------------------------
# RX machinery
# ---------------------------------------------------------------------------


def synchronize(cfg: PLSConfig, buffer_rx_time: np.ndarray) -> np.ndarray:
    """Perfect-timing CP strip of the data symbols (pls_aio.py:427-457)."""
    out = np.zeros((cfg.num_ant, cfg.num_data_symb * cfg.nfft), dtype=complex)
    dc = 0
    for i, kind in enumerate(cfg.symbol_pattern()):
        if kind == 1:
            seg = buffer_rx_time[:, i * cfg.symb_len:(i + 1) * cfg.symb_len]
            out[:, dc * cfg.nfft:(dc + 1) * cfg.nfft] = seg[:, cfg.cp_len:]
            dc += 1
    return out


def channel_estimate(cfg: PLSConfig, rx_data: np.ndarray,
                     ref_sig: np.ndarray) -> np.ndarray:
    """[S, SB, n_rx, sbs] per-bin LS estimate y*conj(ref)/|ref|
    (pls_aio.py:460-492) arranged into subband matrices (:502-521)."""
    bins = np.asarray(cfg.used_data_bins())
    S, B = cfg.num_data_symb, cfg.num_data_bins
    est = np.zeros((cfg.num_ant, S * B), dtype=complex)
    for s in range(S):
        for ant in range(cfg.num_ant):
            f = np.fft.fft(rx_data[ant, s * cfg.nfft:(s + 1) * cfg.nfft],
                           cfg.nfft)
            est[ant, s * B:(s + 1) * B] = (f[bins] * np.conj(ref_sig[s]) /
                                           np.abs(ref_sig[s]))
    sbs = cfg.subband_size
    out = np.zeros((S, cfg.num_subbands, cfg.num_ant, sbs), dtype=complex)
    for s in range(S):
        for sb in range(cfg.num_subbands):
            out[s, sb] = est[:, s * B + sb * sbs: s * B + (sb + 1) * sbs]
    return out


def sv_decomp(chan_sb: np.ndarray):
    """Phase-normalised SVD per subband matrix (pls_aio.py:523-544)."""
    S, SB, n, _ = chan_sb.shape
    lsv = np.zeros_like(chan_sb)
    sval = np.zeros((S, SB, n))
    rsv = np.zeros_like(chan_sb)
    for s in range(S):
        for sb in range(SB):
            u, sv, vh = np.linalg.svd(chan_sb[s, sb])
            v = np.conj(vh).T
            lsv[s, sb] = u @ np.diag(np.exp(-1j * np.angle(u[0, :])))
            rsv[s, sb] = v @ np.diag(np.exp(-1j * np.angle(v[0, :])))
            sval[s, sb] = sv
    return lsv, sval, rsv


def pmi_estimate(cfg: PLSConfig, rx_precoder: np.ndarray):
    """Min Frobenius distance to the codebook (pls_aio.py:546-577)."""
    cb = codebook(cfg)
    S, SB = cfg.num_data_symb, cfg.num_subbands
    pmi = np.zeros((S, SB), dtype=int)
    for s in range(S):
        for sb in range(SB):
            d = np.linalg.norm(rx_precoder[s, sb][None] - cb, axis=(1, 2))
            pmi[s, sb] = int(np.argmin(d))
    bits = ((pmi[..., None] >> np.arange(cfg.bit_codebook - 1, -1, -1)) & 1)
    return pmi, bits.reshape(-1)


def receive(cfg: PLSConfig, rx_time: np.ndarray, ref_sig: np.ndarray):
    rx_data = synchronize(cfg, rx_time)
    h_sb = channel_estimate(cfg, rx_data, ref_sig)
    lsv, sval, rsv = sv_decomp(h_sb)
    pmi, bits = pmi_estimate(cfg, rsv)
    return lsv, rsv, bits


# ---------------------------------------------------------------------------
# Channel + full exchange driver (topblock.py:21-95)
# ---------------------------------------------------------------------------


def mimo_channel(cfg: PLSConfig, tx: np.ndarray,
                 h: np.ndarray | None = None) -> np.ndarray:
    """Per-pair convolution; default all-ones CIRs as topblock.py:56-59."""
    n = cfg.num_ant
    if h is None:
        h = np.ones((n, n, 1), dtype=complex)
    taps = h.shape[-1]
    out = np.zeros((n, tx.shape[1] + taps - 1), dtype=complex)
    for rx in range(n):
        for t in range(n):
            hh = h[rx, t] / np.linalg.norm(h[rx, t])
            out[rx] += np.convolve(tx[t], hh)
    return out[:, :tx.shape[1] + taps - 1]


def key_exchange(cfg: PLSConfig, key_bits: np.ndarray,
                 rng: np.random.Generator | None = None,
                 h: np.ndarray | None = None):
    """Full 3-state exchange; returns (recovered_bits, n_bit_errors)."""
    rng = rng or np.random.default_rng(0)
    ref_a = ref_signal(cfg)
    # state 0: Alice
    ua = unitary_gen(cfg, rng)
    tx_a = transmit(cfg, ua, ref_a)
    rx_b = mimo_channel(cfg, tx_a, h)[:, :cfg.frame_len]
    # state 1: Bob
    lsv_b, _, _ = receive(cfg, rx_b, ref_a)
    f = bits_to_precoders(cfg, key_bits)
    prec_b = rotated_precoder(f, lsv_b)
    ref_b = ref_signal(cfg)
    tx_b = transmit(cfg, prec_b, ref_b)
    # physical reciprocity: h_BA[rx, tx] = h_AB[tx, rx]
    h_back = None if h is None else np.swapaxes(h, 0, 1)
    rx_a = mimo_channel(cfg, tx_b, h_back)[:, :cfg.frame_len]
    # state 2: Alice
    _, _, bits_obs = receive(cfg, rx_a, ref_b)
    err = int(np.bitwise_xor(bits_obs, np.asarray(key_bits).ravel()).sum())
    return bits_obs, err
