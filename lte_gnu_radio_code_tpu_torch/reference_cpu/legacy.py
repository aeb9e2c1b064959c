"""CPU oracle for the legacy CFO-search / DSSS RX blocks (R4/R5).

Literal NumPy replication of one work() call of
LEGACY/gr-ofdm-rx/python/SynchEstAndFO.py:233-363 and
SynchEstFOAndDSSS.py:269-412, kept loop-for-loop faithful so the models
can be tested against it.  The port's own copy of
``lte_gnu_radio_code_tpu/reference_cpu/legacy.py`` (the port imports nothing
of the JAX package); the two give the same arrays bit for bit.

Deliberate deviation (documented per SURVEY.md §7.3): the reference's data
path re-applies ``self.dmax_tmp_ind`` — the winning CFO index of the *last
trial processed* (SynchEstAndFO.py:332), not of the detection row — a latent
bug that is invisible for the shipped fo_range=[0] usage
(examples/top_block.py:129).  The oracle stores the per-detection CFO winner
and uses it in the data path; with a single CFO candidate both coincide.
"""

from __future__ import annotations

import numpy as np

from ..utils.params import OFDMConfig, used_bins
from .golden import zadoff_chu


def cfo_bank(nfft: int, fs: float, fo_range) -> np.ndarray:
    """CFO mixer bank exp(+j*2*pi*fo/fs*n) (SynchEstAndFO.py:196)."""
    return np.exp(1j * 2 * np.pi * (1.0 / fs) *
                  np.outer(np.asarray(fo_range, float), np.arange(nfft)))


def dsss_code(dsss: int, prime: int = 37) -> np.ndarray:
    """ZC spreading code of length ``dsss`` (SynchEstFOAndDSSS.py:253-262)."""
    return zadoff_chu(dsss, prime, parity_even=(dsss % 2 == 0))


def rx_frame_cfo(cfg: OFDMConfig, in0: np.ndarray, fo_range=(0.0,),
                 dsss: int = 1, max_det: int = 100):
    """Multi-detection CFO-search RX, optional DSSS despread.

    Returns dict with time_synch_ref [max_det,4] (ptr, delay, peak, fo_idx),
    est_chan_freq [max_det, nfft], est_data_freq [max_det, num_data_bins],
    despread [max_det, num_data_bins/dsss] (if dsss>1), n_det.
    """
    nfft, cp = cfg.nfft, cfg.cp_len
    m0 = cfg.m_synch
    rx_b_len = cfg.rx_b_len
    _, synch_bins_p = used_bins(nfft, cfg.num_synch_bins)
    _, data_bins_p = used_bins(nfft, cfg.num_data_bins)
    synch_bins_p = list(synch_bins_p)
    data_bins_p = list(data_bins_p)
    zc = zadoff_chu(cfg.mm, cfg.zc_prime,
                    parity_even=(cfg.num_synch_bins % 2 == 0))
    snr_lin = cfg.snr_linear
    cfo = cfo_bank(nfft, cfg.fs, fo_range)
    del_mat_exp = np.tile(np.exp((1j * 2.0 * np.pi / nfft) *
                                 np.outer(np.arange(cp + 1), synch_bins_p)),
                          (1, m0))
    stride = cfg.stride
    start_samp = cp

    n_trials = int(np.around(len(in0) / stride))
    time_synch_ref = np.zeros((max_det, 4))
    est_chan_freq = np.zeros((max_det, nfft), dtype=complex)
    est_data_freq = np.zeros((max_det, cfg.num_data_bins), dtype=complex)
    cor_obs = -1

    for P in range(n_trials):
        if m0 * rx_b_len + P * stride + nfft + start_samp >= len(in0):
            continue
        win = np.zeros(m0 * nfft, dtype=complex)
        for ll in range(m0):
            a = rx_b_len * ll + P * stride + start_samp
            win[ll * nfft:(ll + 1) * nfft] = in0[a:a + nfft]

        dmax_ind0 = np.zeros(len(fo_range), dtype=int)
        dmax_val0 = np.zeros(len(fo_range))
        synchdats = []
        for fo in range(len(fo_range)):
            sd = np.zeros(m0 * cfg.num_synch_bins, dtype=complex)
            for ll in range(m0):
                f = np.fft.fft(win[ll * nfft:(ll + 1) * nfft] * cfo[fo], nfft)
                sd[ll * cfg.num_synch_bins:(ll + 1) * cfg.num_synch_bins] = \
                    f[synch_bins_p]
            p_est = np.sqrt(len(sd) / np.sum(sd * np.conj(sd)))
            sd = p_est * sd
            synchdats.append(sd)
            del_mat = del_mat_exp @ (sd * np.conj(zc))
            dmax_ind0[fo] = int(np.argmax(np.abs(del_mat)))
            dmax_val0[fo] = float(np.max(np.abs(del_mat)))

        fo_win = int(np.argmax(dmax_val0))
        dmax_val = dmax_val0[fo_win]
        dmax_ind = dmax_ind0[fo_win]
        synchdat = synchdats[fo_win]

        if dmax_val > cfg.detection_gate * len(synchdat):
            last_ptr = time_synch_ref[max(cor_obs, 0)][0]
            if (P * stride + start_samp - last_ptr > 2 * cp + nfft) or cor_obs == -1:
                cor_obs += 1
                if cor_obs >= max_det:
                    break
                time_synch_ref[cor_obs] = [P * stride + start_samp, dmax_ind,
                                           int(dmax_val), fo_win]
                data_recov = del_mat_exp[dmax_ind] * synchdat
                tmp_v1 = (data_recov * np.conj(zc)) / (1.0 / snr_lin + 1.0)
                chan_est = np.mean(
                    np.reshape(tmp_v1, (m0, cfg.num_synch_bins)), axis=0)
                chan_est1 = np.zeros(nfft, dtype=complex)
                chan_est1[synch_bins_p] = chan_est
                est_chan_freq[cor_obs] = chan_est1

    # data demod: ONE symbol per detection (SynchEstAndFO.py:323-356)
    for P in range(cor_obs + 1):
        if time_synch_ref[P][0] + m0 * rx_b_len + nfft - 1 > len(in0):
            continue
        data_ptr = int(time_synch_ref[P][0] + m0 * rx_b_len)
        fo_idx = int(time_synch_ref[P][3])
        t_vec = np.fft.fft(in0[data_ptr:data_ptr + nfft] * cfo[fo_idx], nfft)
        freq_data_0 = t_vec[data_bins_p]
        p_est0 = np.sqrt(len(freq_data_0) /
                         np.dot(freq_data_0, np.conj(freq_data_0)))
        data_recov_0 = freq_data_0 * p_est0
        arg_val = (1j * 2.0 * np.pi / nfft) * time_synch_ref[P][1] * \
            np.array(data_bins_p)
        data_recov_z = data_recov_0 * np.exp(arg_val)
        chan_est_dat = est_chan_freq[P][data_bins_p]
        eq_gain_q = np.conj(chan_est_dat) / (
            1.0 / snr_lin + chan_est_dat * np.conj(chan_est_dat))
        est_data_freq[P] = eq_gain_q * data_recov_z

    out = dict(time_synch_ref=time_synch_ref, est_chan_freq=est_chan_freq,
               est_data_freq=est_data_freq, n_det=cor_obs + 1)

    if dsss > 1:
        sc = dsss_code(dsss)
        nspread = cfg.num_data_bins // dsss
        despread = np.zeros((max_det, nspread), dtype=complex)
        for P in range(cor_obs + 1):
            for pl in range(nspread):
                chips = est_data_freq[P][pl * dsss:(pl + 1) * dsss]
                despread[P][pl] = np.mean(chips * np.conj(sc))
        out["despread"] = despread
    return out
