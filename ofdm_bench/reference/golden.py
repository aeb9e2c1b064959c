"""The plain reference: a frozen copy of the port's literal NumPy float64
oracle (``lte_gnu_radio_code_tpu_torch/reference_cpu/golden.py``), kept here
so that the benchmark's reference loads nothing of the program.  It runs on
``reference/numerology.py``'s ``RefConfig`` in place of the program's
``OFDMConfig``; the function bodies are the oracle's, unchanged.

Reference provenance (file:line cited per function):
  TX      : LEGACY/gr-ofdm-rx/python/txrx_mod/MultiAntennaSystem.py:113-218
  ZC      : txrx_mod/SynchSignal.py:25-30; gr-RXOFDM/python/synch_and_chan_est.py:53-64
  channel : txrx_mod/MultiAntennaSystem.py:60-96,221-231
  AWGN    : txrx_mod/MultiAntennaSystem.py:235-260
  RX      : TEST/GNU_RADIO_OFFLINE/synch_and_chan_est.py:164-293 (offline R10)
  stream  : gr-RXOFDM/python/synch_and_chan_est.py:144-250
  LLR     : LEGACY/gr-ofdm-rx/python/BitRecovery.py:66-157
"""

from __future__ import annotations

import numpy as np

from .numerology import RefConfig as OFDMConfig
from .numerology import used_bins

def zadoff_chu(mm: int, prime: int, parity_even: bool | None = None) -> np.ndarray:
    """Length-``mm`` Zadoff-Chu sequence.

    Even form  exp(-j*pi*p*n^2/mm), odd form exp(-j*pi*p*n*(n+1)/mm)
    (SynchSignal.py:27-30).  ``parity_even`` defaults to ``mm % 2 == 0``.
    """
    if parity_even is None:
        parity_even = (mm % 2 == 0)
    n = np.arange(mm)
    if parity_even:
        phase = n * n
    else:
        phase = n * (n + 1)
    return np.exp(-1j * (2.0 * np.pi / mm) * prime * phase / 2.0)


def zc_for_config(cfg: OFDMConfig) -> np.ndarray:
    if cfg.zc_parity_on == "mm":
        parity_even = (cfg.mm % 2 == 0)
    else:  # "bins" — gr-RXOFDM/python/synch_and_chan_est.py:56-61
        parity_even = (cfg.num_synch_bins % 2 == 0)
    return zadoff_chu(cfg.mm, cfg.zc_prime, parity_even)


# pi/8-offset QPSK constellation, decimal {0,1,2,3} -> exp(j*2*pi/8*{1,-1,3,5})
# (MultiAntennaSystem.py:171-178, BitRecovery.py:45-52).
QPSK_POINTS = np.exp(1j * 2.0 * np.pi / 8.0 * np.array([1.0, -1.0, 3.0, 5.0]))


def qpsk_map(bits: np.ndarray) -> np.ndarray:
    """MSB-first bit pairs -> constellation points (MultiAntennaSystem.py:159-178)."""
    b = np.asarray(bits).reshape(-1, 2)
    dec = 2 * b[:, 0] + b[:, 1]
    return QPSK_POINTS[dec]


def bpsk_map(bits: np.ndarray) -> np.ndarray:
    """2*b - 1 (MultiAntennaSystem.py:156-157)."""
    return (2.0 * np.asarray(bits) - 1.0).astype(complex)


def tx_frame(cfg: OFDMConfig, bits: np.ndarray) -> np.ndarray:
    """Full TX chain: bits -> QPSK -> bin placement -> IFFT+CP -> power norm.

    Replicates MultiAntennaSystem.multi_ant_binary_map (:113-187) and
    multi_ant_symb_gen (:189-218) for the SISO stream, including the
    two-stage per-symbol normalisation (energy scale then 1/sqrt(np.var)).
    Returns the time-domain frame of length cfg.frame_len (complex128).
    """
    nfft, cp = cfg.nfft, cfg.cp_len
    _, synch_bins_p = used_bins(nfft, cfg.num_synch_bins)
    _, data_bins_p = used_bins(nfft, cfg.num_data_bins)
    zc = zc_for_config(cfg)
    pattern = cfg.symbol_pattern()
    assert len(pattern) == cfg.num_ofdm_symb

    bits = np.asarray(bits).ravel()
    assert bits.size == cfg.num_bits, (bits.size, cfg.num_bits)
    bpb = cfg.bits_per_bin

    # Frequency-domain grid, one row per OFDM symbol.
    grid = np.zeros((cfg.num_ofdm_symb, nfft), dtype=complex)
    loop_data = 0
    synch_state = 0
    for symb, kind in enumerate(pattern):
        if kind == 0:
            # synch symbol: slice of the MM-long ZC on the synch bins.
            # NOTE the reference never advances synch_state
            # (MultiAntennaSystem.py:146 is a no-op `%`), a latent bug that is
            # invisible for M[0]==1; we implement the intended rotation, which
            # coincides with the reference for every shipped config.
            seg = cfg.num_synch_bins
            grid[symb, list(synch_bins_p)] = zc[synch_state * seg:(synch_state + 1) * seg]
            synch_state = (synch_state + 1) % cfg.m_synch
        else:
            nb = cfg.num_data_bins * bpb
            chunk = bits[loop_data * nb:(loop_data + 1) * nb]
            if cfg.modulation == "QPSK":
                pts = qpsk_map(chunk)
            elif cfg.modulation == "BPSK":
                pts = bpsk_map(chunk)
            else:
                raise ValueError("oracle TX supports BPSK/QPSK only (as the reference)")
            grid[symb, list(data_bins_p)] = pts
            loop_data += 1

    # Per-symbol IFFT + CP + normalisation (MultiAntennaSystem.py:189-218).
    out = np.zeros(cfg.frame_len, dtype=complex)
    min_pow = 1e-30
    for symb in range(cfg.num_ofdm_symb):
        data_ifft = np.fft.ifft(grid[symb], nfft)
        data_time = np.concatenate((data_ifft[-cp:], data_ifft))
        sig_energy = abs(np.dot(data_time, np.conj(data_time).T))
        scale = np.sqrt(len(data_time) / sig_energy) if sig_energy > min_pow else 1.0
        data_time = data_time * scale
        p = np.var(data_time)
        out[symb * cfg.rx_b_len:(symb + 1) * cfg.rx_b_len] = data_time / np.sqrt(p)
    return out


CHANNELS_SISO = {
    # TEST/GNU_RADIO_OFFLINE/synch_and_chan_est.py:126-141
    "Ideal": np.array([1.0 + 0j]),
    "IMT1": np.array([0.0, 1.0 + 0j]),
    "IMT16": np.array([0.0] * 15 + [1.0 + 0j]),
    "Fading": np.array([0.3977, 0.7954 - 0.3977j, -0.1988, 0.0994, -0.0398]),
    # 'AWGN' channel = unit tap at index 1 (MultiAntennaSystem.py:81-82)
    "AWGN": np.array([0.0, 1.0 + 0j]),
}


def channel_taps(name: str) -> np.ndarray:
    """Unit-normalised SISO CIR (MultiAntennaSystem.py:86)."""
    h = CHANNELS_SISO[name]
    return h / np.linalg.norm(h)


def apply_channel(sig: np.ndarray, h: np.ndarray,
                  max_impulse: int | None = None) -> np.ndarray:
    """np.convolve per antenna (MultiAntennaSystem.rx_signal_gen:221-231).

    The reference stores the CIR zero-padded to ``max_impulse = NFFT`` taps
    (MultiAntennaSystem.py:28,46) so the convolved output carries an
    NFFT-1-sample tail; replicate when ``max_impulse`` is given.
    """
    if max_impulse is not None and len(h) < max_impulse:
        h = np.concatenate([h, np.zeros(max_impulse - len(h), dtype=h.dtype)])
    return np.convolve(sig, h)


def awgn(cfg: OFDMConfig, rx: np.ndarray, rng: np.random.Generator,
         sig_pow: float) -> np.ndarray:
    """Complex AWGN with the reference's Digital/Analog SNR conventions
    (MultiAntennaSystem.additive_noise:235-260).  ``sig_pow`` is np.var of the
    *TX* time buffer, as the reference computes it."""
    bits_per_symb = cfg.num_data_bins * cfg.bits_per_bin
    samp_per_symb = cfg.rx_b_len
    if cfg.snr_type == "Digital":
        noise_var = (1.0 / bits_per_symb) * samp_per_symb * sig_pow * 10 ** (-cfg.snr_db / 10)
    else:
        noise_var = sig_pow * 10 ** (-cfg.snr_db / 10)
    n = (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    return rx + np.sqrt(noise_var / 2.0) * n


def rx_frame(cfg: OFDMConfig, in0: np.ndarray, perfect_chan_est: bool = False,
             genie_h: np.ndarray | None = None):
    """Synchronise, estimate the channel, equalise every data symbol.

    Literal port of TEST/GNU_RADIO_OFFLINE/synch_and_chan_est.py:work
    (:164-293): stride-1 delay-search correlation against the ZC under
    cp_len+1 delay hypotheses, first-crossing detection gate with refractory
    window, single lock (``break``), per-block data demod, and the
    interleaved-row `np.delete` pruning.

    Returns (data_phasors [num_data_symb, num_data_bins],
             time_synch_ref (ptr, delay, peak),
             chan_est_time [nfft]).
    """
    nfft, cp = cfg.nfft, cfg.cp_len
    m0 = cfg.m_synch
    rx_b_len = cfg.rx_b_len
    _, synch_bins_p = used_bins(nfft, cfg.num_synch_bins)
    _, data_bins_p = used_bins(nfft, cfg.num_data_bins)
    synch_bins_p = list(synch_bins_p)
    data_bins_p = list(data_bins_p)
    zc = zc_for_config(cfg)
    snr_lin = cfg.snr_linear

    del_mat_exp = np.tile(np.exp((1j * 2.0 * np.pi / nfft) *
                                 np.outer(np.arange(cp + 1), synch_bins_p)), (1, m0))
    stride = cfg.stride
    start_samp = cp

    n_trials = int(np.around(len(in0) / stride))
    n_unique_symb = int(np.floor(len(in0) / rx_b_len))
    n_data_symb = int(n_unique_symb * (cfg.synch_dat[1] / cfg.pattern_len))

    time_synch_ref = np.zeros(3)
    corr_obs = -1
    chan_est_freq_p = np.zeros(nfft, dtype=complex)
    chan_est_tim = np.zeros(nfft, dtype=complex)

    # ---- Stage A: sync search + channel estimate (single lock) ----------
    for P in range(n_trials):
        if m0 * rx_b_len + P * stride + nfft + start_samp >= len(in0):
            continue
        win = np.zeros(m0 * nfft, dtype=complex)
        for ll in range(m0):
            a = rx_b_len * ll + P * stride + start_samp
            win[ll * nfft:(ll + 1) * nfft] = in0[a:a + nfft]
        synchdat0 = np.zeros(m0 * cfg.num_synch_bins, dtype=complex)
        for ll in range(m0):
            f = np.fft.fft(win[ll * nfft:(ll + 1) * nfft], nfft)
            synchdat0[ll * cfg.num_synch_bins:(ll + 1) * cfg.num_synch_bins] = f[synch_bins_p]
        p_est = np.sqrt(len(synchdat0) / np.sum(synchdat0 * np.conj(synchdat0)))
        synchdat = p_est * synchdat0
        del_mat = del_mat_exp @ (synchdat * np.conj(zc))
        dmax_ind = int(np.argmax(np.abs(del_mat)))
        dmax_val = float(np.max(np.abs(del_mat)))

        if dmax_val > cfg.detection_gate * len(synchdat):
            if (P * stride + start_samp - time_synch_ref[0] > 2 * cp + nfft) or corr_obs == -1:
                corr_obs += 1
                time_synch_ref[0] = P * stride + start_samp
                time_synch_ref[1] = dmax_ind
                time_synch_ref[2] = int(dmax_val)

                data_recov = del_mat_exp[dmax_ind] * synchdat
                tmp_v1 = (data_recov * np.conj(zc)) / (1.0 / snr_lin + 1.0)
                chan_est00 = np.reshape(tmp_v1, (m0, cfg.num_synch_bins))
                if perfect_chan_est and genie_h is not None:
                    hf = np.fft.fft(genie_h, nfft)
                    chan_est00 = np.tile(hf[synch_bins_p], (m0, 1))
                chan_est = np.sum(chan_est00, axis=0) / float(m0)

                chan_est1 = np.zeros(nfft, dtype=complex)
                chan_est1[synch_bins_p] = chan_est
                chan_est_freq_p = chan_est1
                chan_est_tim = np.fft.ifft(chan_est1, nfft)
                break  # single lock (TEST synch_and_chan_est.py:253)

    # ---- Stage B: data demod per pattern block ---------------------------
    est_data_freq = np.zeros((n_unique_symb, cfg.num_data_bins), dtype=complex)
    for P in range(n_unique_symb)[::cfg.pattern_len]:
        data_ptr = int(time_synch_ref[0] + m0 * rx_b_len * (P + 1))
        if time_synch_ref[0] + m0 * rx_b_len * (P + 1) + nfft - 1 > len(in0):
            continue
        for N in range(cfg.synch_dat[1]):
            s = data_ptr + rx_b_len * N
            t_vec = np.fft.fft(in0[s:s + nfft], nfft)
            freq_data_0 = t_vec[data_bins_p]
            p_est0 = np.sqrt(len(freq_data_0) / np.dot(freq_data_0, np.conj(freq_data_0)))
            data_recov_0 = freq_data_0 * p_est0
            arg_val = (1j * 2.0 * np.pi / nfft) * time_synch_ref[1] * np.array(data_bins_p)
            data_recov_z = data_recov_0 * np.exp(arg_val)
            chan_est_dat = chan_est_freq_p[data_bins_p]
            eq_gain_q = np.conj(chan_est_dat) / (1.0 / snr_lin + chan_est_dat * np.conj(chan_est_dat))
            if P + N < n_unique_symb:
                est_data_freq[P + N] = eq_gain_q * data_recov_z

    # prune the interleaved never-written rows (TEST synch_and_chan_est.py:285)
    data_demod = np.delete(est_data_freq,
                           list(range(3, est_data_freq.shape[0], cfg.pattern_len)), axis=0)
    return data_demod[:n_data_symb], time_synch_ref, chan_est_tim


def rx_stream(cfg: OFDMConfig, in0: np.ndarray, max_det: int = 100):
    """Continuous multi-frame RX: every gate crossing is a detection; the
    channel estimate is refreshed PER DETECTION and that detection's pattern
    block is demodulated with its own estimate — forever, over the whole
    buffer.

    Literal port of the gr-RXOFDM flagship block's work() run over a long
    stream (gr-RXOFDM/python/synch_and_chan_est.py):
      * stage A :144-221 — sliding delay-search correlation, detection gate
        0.4*L with refractory window 2*cp+nfft against the LAST accepted
        pointer (:170-173), a `time_synch_ref` multi-detection table
        (max_num_corr=100 rows, :86-88) and a fresh channel estimate stored
        per detection (`est_chan_freq_P[cor_obs]`, :181-192);
      * stage B :224-250 — per detection P, demodulate the data following
        `time_synch_ref[P][0] + M[0]*rx_b_len` with detection P's own channel
        row and delay.  (The shipped block FFTs only the first data symbol;
        here all synch_dat[1] data symbols of the detection's pattern block
        are demodulated — the block-repetition semantics of the utsa variant,
        gr-utsa_ofdm/python/SynchAndChanEst.py:221-248.)

    Unlike :func:`rx_frame` (single lock + ``break``), this is the semantics
    the D1 loopback app actually exercises with the TX pickle replayed
    continuously: re-acquisition tracks timing drift and channel changes.

    Returns a dict with
      ptrs [n_det], delays [n_det], peaks [n_det],
      chans [n_det, nfft]   (freq-domain estimate per detection),
      phasors [n_det, synch_dat[1], num_data_bins],
      demod_ok [n_det] bool (stage-B window fit — False near buffer end).
    """
    nfft, cp = cfg.nfft, cfg.cp_len
    m0, nd = cfg.m_synch, cfg.synch_dat[1]
    rx_b_len = cfg.rx_b_len
    _, synch_bins_p = used_bins(nfft, cfg.num_synch_bins)
    _, data_bins_p = used_bins(nfft, cfg.num_data_bins)
    synch_bins_p = list(synch_bins_p)
    data_bins_p = list(data_bins_p)
    zc = zc_for_config(cfg)
    snr_lin = cfg.snr_linear
    del_mat_exp = np.tile(np.exp((1j * 2.0 * np.pi / nfft) *
                                 np.outer(np.arange(cp + 1), synch_bins_p)),
                          (1, m0))
    stride = cfg.stride
    start_samp = cp
    gate = cfg.detection_gate * m0 * cfg.num_synch_bins
    refractory = 2 * cp + nfft

    ptrs, delays, peaks, chans = [], [], [], []
    last_ptr = 0
    n_trials = max(0, (len(in0) - (m0 * rx_b_len + nfft + start_samp) - 1)
                   // stride + 1)

    # ---- stage A: every un-refractory gate crossing is a detection --------
    for P in range(n_trials):
        ptr = P * stride + start_samp
        win = np.zeros(m0 * nfft, dtype=complex)
        for ll in range(m0):
            a = rx_b_len * ll + ptr
            win[ll * nfft:(ll + 1) * nfft] = in0[a:a + nfft]
        synchdat0 = np.zeros(m0 * cfg.num_synch_bins, dtype=complex)
        for ll in range(m0):
            f = np.fft.fft(win[ll * nfft:(ll + 1) * nfft], nfft)
            synchdat0[ll * cfg.num_synch_bins:(ll + 1) * cfg.num_synch_bins] \
                = f[synch_bins_p]
        p_est = np.sqrt(len(synchdat0) / np.sum(synchdat0 * np.conj(synchdat0)))
        synchdat = p_est * synchdat0
        del_mat = del_mat_exp @ (synchdat * np.conj(zc))
        dmax_ind = int(np.argmax(np.abs(del_mat)))
        dmax_val = float(np.max(np.abs(del_mat)))
        if dmax_val > gate and ((ptr - last_ptr > refractory) or not ptrs):
            if len(ptrs) >= max_det:
                break
            last_ptr = ptr
            data_recov = del_mat_exp[dmax_ind] * synchdat
            tmp_v1 = (data_recov * np.conj(zc)) / (1.0 / snr_lin + 1.0)
            chan_est = np.mean(np.reshape(tmp_v1, (m0, cfg.num_synch_bins)),
                               axis=0)
            chan_full = np.zeros(nfft, dtype=complex)
            chan_full[synch_bins_p] = chan_est
            ptrs.append(ptr)
            delays.append(dmax_ind)
            peaks.append(dmax_val)
            chans.append(chan_full)

    # ---- stage B: demod each detection's pattern block with ITS channel ---
    n_det = len(ptrs)
    phasors = np.zeros((n_det, nd, cfg.num_data_bins), dtype=complex)
    demod_ok = np.zeros(n_det, dtype=bool)
    for i in range(n_det):
        data_ptr = ptrs[i] + m0 * rx_b_len
        if data_ptr + (nd - 1) * rx_b_len + nfft > len(in0):
            continue
        demod_ok[i] = True
        chan_est_dat = chans[i][data_bins_p]
        eq_gain = np.conj(chan_est_dat) / (1.0 / snr_lin +
                                           chan_est_dat * np.conj(chan_est_dat))
        rot = np.exp((1j * 2.0 * np.pi / nfft) * delays[i] *
                     np.array(data_bins_p))
        for N in range(nd):
            s = data_ptr + rx_b_len * N
            t_vec = np.fft.fft(in0[s:s + nfft], nfft)
            freq_data_0 = t_vec[data_bins_p]
            p_est0 = np.sqrt(len(freq_data_0) /
                             np.dot(freq_data_0, np.conj(freq_data_0)))
            phasors[i, N] = eq_gain * (freq_data_0 * p_est0) * rot
    return dict(ptrs=np.asarray(ptrs, np.int64),
                delays=np.asarray(delays, np.int64),
                peaks=np.asarray(peaks),
                chans=np.asarray(chans) if n_det else
                np.zeros((0, nfft), complex),
                phasors=phasors, demod_ok=demod_ok)


def bit_recovery(phasors: np.ndarray):
    """QPSK LLR soft demap + hard decisions (BitRecovery.py:66-157).

    Returns (hard_bits [2*n], llr0 [2*n], llr1 [2*n]) where index 2k is the
    real-rail (MSB) bit of symbol k and 2k+1 the imag-rail (LSB) bit.
    """
    d = np.asarray(phasors).ravel()
    n = d.size
    z = d[:, None] - QPSK_POINTS[None, :]
    dmin_ind = np.argmin(np.abs(z), axis=1)
    dmin = np.min(np.abs(z), axis=1)
    ez = d - QPSK_POINTS[dmin_ind]

    sigma = 0.7071067811865476 * np.mean(np.abs(dmin))
    dfact = 1.0 / (sigma * sigma)
    K = 1.414213562373095

    llrp0 = np.zeros(2 * n)
    llrp1 = np.zeros(2 * n)
    er, ei = np.abs(ez.real), np.abs(ez.imag)
    re_pos = d.real >= 0
    im_pos = d.imag >= 0
    near_r = -0.5 * dfact * er
    far_r = -0.5 * dfact * (K - er)
    near_i = -0.5 * dfact * ei
    far_i = -0.5 * dfact * (K - ei)
    # real rail: bit=0 hypothesis favoured when Re>=0
    llrp0[0::2] = np.where(re_pos, near_r, far_r)
    llrp1[0::2] = np.where(re_pos, far_r, near_r)
    # imag rail: bit=0 hypothesis favoured when Im>=0
    llrp0[1::2] = np.where(im_pos, near_i, far_i)
    llrp1[1::2] = np.where(im_pos, far_i, near_i)

    hard = (0.5 * (np.sign(llrp1 - llrp0) + 1.0)).astype(int)
    return hard, llrp0, llrp1
