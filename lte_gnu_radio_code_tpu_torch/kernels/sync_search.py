"""K4: the fused sync search — |corr| of every stride-spaced trial and delay
hypothesis, with the synch-bin power normalisation fused in.

Port of ``lte_gnu_radio_code_tpu/pallas_kernels/sync_search.py``
(``sync_corr_abs``).  On a CPU tensor the wrapper runs the plain twin
``ops.fast_sync.sync_corr_abs_fast`` (a bank of convolutions).  On a CUDA
tensor it launches one of the two kernels of ``csrc/sync_search.cu``, once
for the whole frame batch, chosen by :func:`route`, a rule on the shape
alone:

* ``"fft"`` — per trial a forward FFT of each synch window, a multiply by
  conj(ZC) on the synch bins and one inverse FFT, in shared memory: where
  nfft is a power of two in [16, 4096] (``kernels/fft.py:takes_fft``),
  cp + 1 <= nfft, and the dense product would cost at least
  ``FFT_ADVANTAGE`` times the FFT form's operations.  Every strided
  configuration (LTE1024, LTE2048) takes it.
* ``"direct"`` — the dense product sum_m x[cp + p s + m] K_d[m], register-
  tiled: every other shape, the stride-1 search of GOLDEN64 among them, as
  long as one trial's taps fit in a block's shared memory (the library's
  ``sync_search_direct_fits`` says); ``ValueError`` otherwise.

Neither kernel falls back to the other or to a plain version.  The ZC
sequence the search correlates with is a parameter (default
``zc_for_config(cfg)``); its tables are cached on the config and the
sequence's bytes (``ops.fast_sync.zc_key``).
``sync_corr_abs_fft_plain`` is the FFT route's plain version, used by the
tests and ``chip_smoke.py`` only.

Each kernel has two output forms.  :func:`sync_corr_abs` gives the surface
``[..., n_trials, cp+1]``; :func:`sync_peaks` gives each trial's peak and
its delay, ``surface.max(-1)`` bit for bit (ties to the lowest delay),
reduced inside the kernel so that the surface is never written: the form
for every caller whose next step is that reduction.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops import fast_sync
from ..utils.params import OFDMConfig
from ..utils.tables import device_table
from . import _cuda, fft

launches = 0                                  # kernel launches since reset
route_launches = {"fft": 0, "direct": 0}      # the same, by route (running)
peak_launches = {"fft": 0, "direct": 0}       # of those, in the peaks form

sync_corr_abs_plain = fast_sync.sync_corr_abs_fast     # the plain twin
sync_corr_abs_fft_plain = fast_sync.sync_corr_abs_fft  # the FFT form, plain


def sync_peaks_plain(cfg: OFDMConfig, x: torch.Tensor, n_trials: int,
                     zc=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The peaks form's plain twin: the twin's surface reduced by
    ``max(-1)``, the delay as int32."""
    peak, delay = sync_corr_abs_plain(cfg, x, n_trials, zc).max(-1)
    return peak, delay.to(torch.int32)

# The FFT route is taken where the product costs at least this many times
# the FFT form's operations: the in-block transforms run far below the FFMA
# rate that the register-tiled product reaches (PERF.md, K4).
FFT_ADVANTAGE = 4.0


def direct_ops(nfft: int, cp: int, m_synch: int) -> int:
    """Float32 operations of one trial in the product form: a complex
    multiply-add (8) per delay and tap inside the synch windows."""
    return 8 * (cp + 1) * m_synch * nfft


def fft_ops(nfft: int, m_synch: int) -> int:
    """Float32 operations of one trial in the FFT form: m_synch forward
    transforms and one inverse at 5 N log2 N, and per window and bin a
    complex multiply-add and the power (12)."""
    return (5 * (m_synch + 1) * nfft * int(math.log2(nfft)) +
            12 * m_synch * nfft)


def route(nfft: int, cp: int, stride: int, m_synch: int) -> str:
    """``"fft"`` or ``"direct"``: the kernel a CUDA tensor of this shape
    goes to (module docstring).  The stride belongs to the shape a route
    is asked for, so the rule takes it, but it moves nothing: both forms do
    their work once per trial, whatever the trials' spacing."""
    if (fft.takes_fft(nfft) and cp + 1 <= nfft and
            direct_ops(nfft, cp, m_synch) >=
            FFT_ADVANTAGE * fft_ops(nfft, m_synch)):
        return "fft"
    return "direct"


@functools.lru_cache(maxsize=32)
def _kernels_t(cfg: OFDMConfig, key: bytes | None = None) -> np.ndarray:
    """[klen, cp+1] correlation kernels, tap-major for the direct kernel."""
    return np.ascontiguousarray(fast_sync._kernels(cfg, key).T)


def _launch(kind: str, cfg: OFDMConfig, x: torch.Tensor, n_trials: int,
            zc=None, form: str = "surface"):
    """Launch the kernel of route ``kind`` on a CUDA tensor in output form
    ``form`` ("surface": the [..., n_trials, cp+1] tensor; "peaks": (peak,
    delay), each [..., n_trials]) (the wrappers' CUDA branch; tests and
    ``chip_smoke.py`` call it to hold either kernel at a shape the rule
    gives to the other)."""
    global launches
    key = fast_sync.zc_key(zc)
    x2 = x.reshape(-1, x.shape[-1])
    b, n = x2.shape
    _cuda.check(x2, "x", torch.complex64, (b, n))
    nfft, cp, m0, dev = cfg.nfft, cfg.cp_len, cfg.m_synch, x.device
    nd = cp + 1
    big_l = float(m0 * cfg.num_synch_bins)
    if form == "surface":
        out = torch.empty(b, n_trials, nd, dtype=torch.float32, device=dev)
        delay = None
    elif form == "peaks":
        out = torch.empty(b, n_trials, dtype=torch.float32, device=dev)
        delay = torch.empty(b, n_trials, dtype=torch.int32, device=dev)
    else:
        raise ValueError(f"unknown output form {form!r}")
    if kind == "fft":
        fft.require(nfft)
        if nd > nfft:
            raise ValueError(f"cp {cp} >= nfft {nfft}: the FFT route reads "
                             "the delays from one length-nfft inverse")
        args = ("sync_search_fft", dev, x2.data_ptr(), b, n,
                device_table(fast_sync._zc_by_bin, dev, cfg, key).data_ptr(),
                device_table(fft.twiddles, dev, nfft).data_ptr(),
                out.data_ptr(), n_trials, cp, cfg.stride, nfft, m0,
                cfg.rx_b_len, big_l)
    elif kind == "direct":
        if not _cuda.library().sync_search_direct_fits(cfg.stride, nfft, m0,
                                                        cfg.rx_b_len):
            raise ValueError(f"nfft {nfft}, cp {cp}, m_synch {m0}: one "
                             "trial's taps do not fit in shared memory")
        args = ("sync_search_direct", dev, x2.data_ptr(), b, n,
                device_table(_kernels_t, dev, cfg, key).data_ptr(), nd,
                out.data_ptr(), n_trials, cp, cfg.stride, nfft, m0,
                cfg.rx_b_len, big_l)
    else:
        raise ValueError(f"unknown route {kind!r}")
    args += (None if delay is None else delay.data_ptr(),)
    if b and n_trials:
        _cuda.launch(*args)
        launches += 1
        route_launches[kind] += 1
        if delay is not None:
            peak_launches[kind] += 1
    lead = x.shape[:-1]
    if delay is None:
        return out.reshape(*lead, n_trials, nd)
    return out.reshape(*lead, n_trials), delay.reshape(*lead, n_trials)


def _check_config(cfg: OFDMConfig) -> None:
    if cfg.num_synch_bins != cfg.nfft - 2:
        raise ValueError("Parseval normalisation requires the canonical "
                         "all-but-DC/Nyquist synch bins")
    if cfg.rx_b_len % 2:
        raise ValueError("the (-1)^n window sign needs even nfft+cp")


def sync_corr_abs(cfg: OFDMConfig, x: torch.Tensor, n_trials: int,
                  zc=None) -> torch.Tensor:
    """|corr| [n_trials, cp+1] for x [n], [B, n_trials, cp+1] for x [B, n]
    (``sync_search.sync_corr_abs``, batched over frames), against the ZC
    sequence ``zc`` (None: ``zc_for_config(cfg)``).  A CPU tensor takes the
    plain twin; a CUDA tensor takes the kernel that
    ``route(nfft, cp, stride, m_synch)`` names, or raises."""
    _check_config(cfg)
    if _cuda.on_cpu(x):
        return sync_corr_abs_plain(cfg, x, n_trials, zc)
    return _launch(route(cfg.nfft, cfg.cp_len, cfg.stride, cfg.m_synch),
                   cfg, x, n_trials, zc)


def sync_peaks(cfg: OFDMConfig, x: torch.Tensor, n_trials: int,
               zc=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Each trial's peak over the delays and its delay: (peak float32,
    delay int32), each [n_trials] for x [n] and [B, n_trials] for x [B, n];
    ``sync_corr_abs(...).max(-1)`` exactly, ties to the lowest delay, with
    the same checks and route rule.  A CPU tensor takes
    :func:`sync_peaks_plain`; a CUDA tensor one launch of the kernel in its
    peaks form."""
    _check_config(cfg)
    if _cuda.on_cpu(x):
        return sync_peaks_plain(cfg, x, n_trials, zc)
    return _launch(route(cfg.nfft, cfg.cp_len, cfg.stride, cfg.m_synch),
                   cfg, x, n_trials, zc, form="peaks")
