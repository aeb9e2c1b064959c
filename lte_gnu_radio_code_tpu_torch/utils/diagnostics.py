"""Diagnostics: the reference's ``diagnostics`` flag machinery, as data
and optional files (genie channel compare, EVM, timestamped pickle / CSV /
MAT dumps, IQ scatter), numpy only.

Copy of ``lte_gnu_radio_code_tpu/utils/diagnostics.py``.  Every reference
block takes a ``diagnostics`` flag gating matplotlib plots and file dumps
(gr-utsa_ofdm/SynchAndChanEst.py:190-200,251-253, BitRecovery.py:159-184,
RXOFDM synch_and_chan_est.py:206-213).  scipy (``dump_mat``) and matplotlib
(``iq_scatter``) stay optional: without them those two write nothing.
Arrays may be numpy arrays or the port's tensors on any device.
"""

from __future__ import annotations

import csv
import datetime
import pathlib
import pickle

import numpy as np


def _np(a) -> np.ndarray:
    """A numpy array of a (a tensor on any device, or anything numpy
    takes)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def genie_channel_compare(nfft: int, chan_est_time: np.ndarray,
                          genie_h: np.ndarray, delay_idx: int = 0) -> dict:
    """Estimated vs true channel frequency response + error metrics
    (gr-utsa_ofdm/SynchAndChanEst.py:118-133 give_genie_chan + :190-200).

    ``delay_idx`` compensates the winning timing derotation the estimator
    absorbed into its channel estimate (synch_and_chan_est.py:181-182)."""
    est_f = np.fft.fft(_np(chan_est_time), nfft)
    rot = np.exp(1j * 2 * np.pi * delay_idx * np.arange(nfft) / nfft)
    true_f = np.fft.fft(_np(genie_h), nfft) * rot
    err = est_f - true_f
    # the estimator only fills the synch bins; DC/Nyquist are structurally
    # zero in the estimate, so also report the error over estimated bins only
    used = np.abs(est_f) > 1e-3 * max(float(np.abs(est_f).max()), 1e-30)
    nmse_used = (np.mean(np.abs(err[used]) ** 2) /
                 max(np.mean(np.abs(true_f[used]) ** 2), 1e-30)
                 if used.any() else np.inf)
    return {
        "est_freq": est_f,
        "true_freq": true_f,
        "mse": float(np.mean(np.abs(err) ** 2)),
        "nmse_db": float(10 * np.log10(
            np.mean(np.abs(err) ** 2) /
            max(np.mean(np.abs(true_f) ** 2), 1e-30))),
        "nmse_used_db": float(10 * np.log10(nmse_used)),
    }


def evm_db(phasors: np.ndarray, reference_points: np.ndarray) -> float:
    """Error-vector magnitude in dB vs the nearest/true constellation."""
    e = _np(phasors).ravel() - _np(reference_points).ravel()
    p = np.mean(np.abs(_np(reference_points)) ** 2)
    return float(10 * np.log10(np.mean(np.abs(e) ** 2) / max(p, 1e-30)))


def _stamp() -> str:
    """The reference's timestamped filename suffix
    (RXOFDM synch_and_chan_est.py:208)."""
    return datetime.datetime.now().strftime("%Y_%m_%d_%Hh_%Mm")


def dump_channel_estimate(directory, file_stem, chan_est_time) -> pathlib.Path:
    """Pickle dump of the CIR, protocol 2 + timestamp (RXOFDM :206-213)."""
    path = pathlib.Path(directory) / f"{file_stem}{_stamp()}.pckl"
    with open(path, "wb") as f:
        pickle.dump(_np(chan_est_time), f, protocol=2)
    return path


def dump_soft_bits(directory, file_stem, llr0, llr1) -> pathlib.Path:
    """Soft-bit pickle (BitRecovery.py:170-179)."""
    path = pathlib.Path(directory) / f"{file_stem}{_stamp()}.pckl"
    with open(path, "wb") as f:
        pickle.dump({"llr0": _np(llr0), "llr1": _np(llr1)},
                    f, protocol=2)
    return path


def dump_hard_bits_csv(directory, file_stem, hard_bits) -> pathlib.Path:
    """Hard-bit CSV (BitRecovery.py:181-184)."""
    path = pathlib.Path(directory) / f"{file_stem}{_stamp()}.csv"
    with open(path, "w", newline="") as f:
        csv.writer(f).writerow(_np(hard_bits).ravel().tolist())
    return path


def dump_mat(directory, file_stem, **arrays):
    """MATLAB cross-check dump (BitRecovery.py:159-165); no-op without scipy."""
    try:
        from scipy.io import savemat
    except ImportError:
        return None
    path = pathlib.Path(directory) / f"{file_stem}{_stamp()}.mat"
    savemat(path, {k: _np(v) for k, v in arrays.items()})
    return path


def iq_scatter(phasors, title="equalised IQ", show=False, save_to=None):
    """Constellation scatter (SynchAndChanEst.py:251-253, SDRScript.py:155-161).

    Returns the (re, im) arrays; draws only when matplotlib is available and
    show/save_to is requested."""
    d = _np(phasors).ravel()
    if show or save_to:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return d.real, d.imag
        fig, ax = plt.subplots()
        ax.plot(d.real, d.imag, ".")
        ax.set_title(title)
        ax.set_xlabel("I")
        ax.set_ylabel("Q")
        if save_to:
            fig.savefig(save_to, dpi=100)
        if show:
            plt.show()
        plt.close(fig)
    return d.real, d.imag
