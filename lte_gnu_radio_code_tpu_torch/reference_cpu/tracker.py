"""CPU oracle for the MATLAB-heritage tracking synchronizer (R6/R11).

Literal port of txrx_mod/RxBasebandSystem.param_est_synch (:91-274) and
rx_data_demod (:276-309) for the SISO stream.  The port's own copy of
``lte_gnu_radio_code_tpu/reference_cpu/tracker.py`` (the port imports
nothing of the JAX package); the two give the same arrays bit for bit.  It
preserves the reference's quirks:

* stride = ceil(cp/2), start sample = cp - 5 (:93,100)
* p_mat uses the +j sign and the winning delay is argmax **minus one** (:156-158)
* pointer state machine: search -> 5 nominal advances -> least-squares drift
  prediction ptr = ceil([1, x] . b - cp/4) over a 5-tap history (:114-119,230-237)
* re-adjust by +cp/2 when the delay lands in the last quarter of the CP,
  *without re-reading the window* (:163-200 recompute the same FFT)
* refractory test against time_synch_ref[max(corr_obs, 1)] (:202-204)
* channel estimate regularised by (1 + 1/SNR) (:236)
* data demod: per-detection symbols at ptr + (sym+1)*(nfft+cp), 'Estimated'
  or 'Ideal' (genie h_f) channel, final per-symbol power renormalisation
  that reads row p instead of row p*nd+sym (:305-309, replicated verbatim)
"""

from __future__ import annotations

import numpy as np

from ..utils.params import OFDMConfig, used_bins
from .golden import zc_for_config


def track_synch(cfg: OFDMConfig, in0: np.ndarray, max_det: int = 250):
    """Returns dict(time_synch_ref [max_det,3], est_chan_freq_p [max_det,nfft],
    n_det, ptr_history)."""
    nfft, cp = cfg.nfft, cfg.cp_len
    m0 = cfg.m_synch
    rx_b_len = cfg.rx_b_len
    _, synch_bins_p = used_bins(nfft, cfg.num_synch_bins)
    synch_bins_p = np.asarray(synch_bins_p)
    zc = zc_for_config(cfg)
    snr = cfg.snr_linear
    pattern = cfg.pattern_len

    stride = int(np.ceil(cp / 2))
    start_samp = (cp - 4) - 1
    total_loops = int(np.ceil(len(in0) / stride))

    p_mat = np.tile(np.exp(1j * 2 * (np.pi / nfft) *
                           np.outer(synch_bins_p, np.arange(cp + 1))),
                    (m0, 1))                         # [m0*L, cp+1]

    tsr = np.zeros((max_det, 3))
    est_chan_freq_p = np.zeros((max_det, nfft), dtype=complex)
    corr_obs = -1
    ptr_adj, loop_count, sym_count = 0, 0, 0
    tap_delay = 5
    x = np.zeros(tap_delay)
    ptr_synch0 = np.zeros(1000)
    ptr_frame = 0.0
    b = np.zeros(2)

    def correlate(pf):
        win = np.zeros(m0 * nfft, dtype=complex)
        for i in range(m0):
            s = int(i * rx_b_len + pf)
            win[i * nfft:(i + 1) * nfft] = in0[s:s + nfft]
        fft_vec = np.fft.fft(win.reshape(m0, nfft), nfft, axis=-1)
        sd0 = fft_vec[:, synch_bins_p].reshape(-1)
        pow_est = np.sum(sd0 * np.conj(sd0)).real / len(sd0)
        sd = sd0 / np.sqrt(pow_est)
        del_mat = np.conj(zc) @ (sd[:, None] * p_mat)
        dd = np.abs(del_mat)
        return sd, float(dd.max()), int(dd.argmax()) - 1

    while loop_count <= total_loops:
        if corr_obs == -1:
            ptr_frame = loop_count * stride + start_samp + ptr_adj
        elif corr_obs < 5:
            ptr_frame += pattern * rx_b_len
        else:
            ptr_frame = float(np.ceil(b[0] + b[1] * (sym_count * pattern)
                                      - cp / 4))

        if (m0 - 1) * rx_b_len + nfft + ptr_frame < len(in0):
            sd, dmax, dmax_ind = correlate(ptr_frame)

            if dmax > 0.5 * len(sd) or corr_obs > -1:
                if dmax_ind > np.ceil(0.75 * cp):
                    if corr_obs == 0:
                        ptr_adj += np.ceil(0.5 * cp)
                        ptr_frame = loop_count * stride + start_samp + ptr_adj
                    elif 0 < corr_obs < 5:
                        ptr_frame += np.ceil(0.5 * cp)
                    # reference recomputes the SAME window's FFT (:163-200);
                    # dmax/dmax_ind are unchanged by construction

                if (ptr_frame - tsr[max(corr_obs, 1), 0] > 2 * cp + nfft
                        or corr_obs == -1):
                    corr_obs += 1
                    if corr_obs >= max_det:
                        break
                    tsr[corr_obs] = [ptr_frame, dmax_ind, dmax]

                    ptr_synch0[sym_count % tap_delay] = ptr_frame + dmax_ind
                    x[sym_count % tap_delay] = sym_count * pattern
                    sym_count += 1

                    if corr_obs > 3:
                        n_h = min(tap_delay, corr_obs)
                        x2 = x[0:n_h]
                        y = ptr_synch0[0:n_h]
                        X = np.stack([np.ones(n_h), x2], axis=1)
                        b = np.linalg.lstsq(X, y, rcond=None)[0]

                    data_recov0 = sd * p_mat[:, dmax_ind + 1]
                    tmp = (data_recov0 * np.conj(zc)) / (1 + 1 / snr)
                    h_est = np.sum(tmp.reshape(m0, -1), axis=0) / m0
                    h1 = np.zeros(nfft, dtype=complex)
                    h1[synch_bins_p] = h_est
                    est_chan_freq_p[corr_obs] = h1
        loop_count += 1

    return dict(time_synch_ref=tsr, est_chan_freq_p=est_chan_freq_p,
                n_det=corr_obs + 1)


def data_demod(cfg: OFDMConfig, in0: np.ndarray, track: dict,
               param_est: str = "Estimated",
               genie_h: np.ndarray | None = None,
               fix_rotation: bool = True) -> np.ndarray:
    """rx_data_demod (:276-309), SISO.

    ``fix_rotation=False`` replicates the reference verbatim, which derotates
    data by ``dmax_ind`` (= argmax-1) while the channel estimate was derotated
    by ``argmax`` (:234 vs :305) — leaving an e^{-j2*pi*k/NFFT} one-sample
    residual on every equalised bin (constellation rotated linearly across
    bins; the heritage simulator never checked BER on this path).  The default
    derotates data by ``dmax_ind + 1`` so both paths use the same timing
    hypothesis and the equaliser output is residual-free for any channel —
    the adjudicated fix per SURVEY.md §7.3."""
    nfft = cfg.nfft
    rx_b_len = cfg.rx_b_len
    _, data_bins_p = used_bins(nfft, cfg.num_data_bins)
    data_bins_p = np.asarray(data_bins_p)
    snr = cfg.snr_linear
    nd = cfg.synch_dat[1]
    tsr = track["time_synch_ref"]
    n_det = track["n_det"]

    est = np.zeros((n_det * nd, cfg.num_data_bins), dtype=complex)
    for p in range(n_det):
        for sym in range(nd):
            if tsr[p, 0] + tsr[p, 1] + tsr[p, 2] + nfft >= len(in0):
                continue
            data_ptr = int(tsr[p, 0] + (sym + 1) * rx_b_len)
            fft_vec = np.fft.fft(in0[data_ptr:data_ptr + nfft], nfft)
            freq_dat0 = fft_vec[data_bins_p]
            p_est = np.sum(freq_dat0 * np.conj(freq_dat0)) / len(freq_dat0)
            data_recov0 = freq_dat0 / np.sqrt(p_est)
            if param_est == "Estimated":
                h_est = track["est_chan_freq_p"][p][data_bins_p]
            else:
                h_est = np.fft.fft(genie_h, nfft)[data_bins_p]
            rot_idx = tsr[p, 1] + 1 if fix_rotation else tsr[p, 1]
            del_rotate = np.exp(1j * 2 * (np.pi / nfft) * data_bins_p *
                                rot_idx)
            data_recov = data_recov0 * del_rotate
            eq = (data_recov * np.conj(h_est)) / (np.conj(h_est) * h_est +
                                                  1 / snr)
            est[p * nd + sym] = eq
            # verbatim reference quirk: renormalise by row p's power
            d = est[p]
            p1 = np.sum(d * np.conj(d)).real / len(d)
            if p1 > 0:
                est[p * nd + sym] /= np.sqrt(p1)
    return est
