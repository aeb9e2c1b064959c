"""K4: the fused sync search — |corr| of every stride-spaced trial and delay
hypothesis, with the Parseval power normalisation fused in.

Port of ``lte_gnu_radio_code_tpu/pallas_kernels/sync_search.py``
(``sync_corr_abs``).  On a CUDA tensor the wrapper launches
``csrc/sync_search.cu`` once for the whole frame batch; on a CPU tensor it
runs the plain twin ``ops.fast_sync.sync_corr_abs_fast``.  The trial stride
is ``cfg.stride``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import fast_sync
from ..utils.params import OFDMConfig
from ..utils.tables import device_table
from . import _cuda

launches = 0          # kernel launches since the last reset

sync_corr_abs_plain = fast_sync.sync_corr_abs_fast     # the plain twin


@functools.lru_cache(maxsize=32)
def _kernels_t(cfg: OFDMConfig) -> np.ndarray:
    """[klen, cp+1] correlation kernels, tap-major for the kernel."""
    return np.ascontiguousarray(fast_sync._kernels(cfg).T)


def sync_corr_abs(cfg: OFDMConfig, x: torch.Tensor,
                  n_trials: int) -> torch.Tensor:
    """|corr| [n_trials, cp+1] for x [n], [B, n_trials, cp+1] for x [B, n]
    (``sync_search.sync_corr_abs``, batched over frames)."""
    global launches
    if cfg.num_synch_bins != cfg.nfft - 2:
        raise ValueError("Parseval normalisation requires the canonical "
                         "all-but-DC/Nyquist synch bins")
    if cfg.rx_b_len % 2:
        raise ValueError("the (-1)^n window sign needs even nfft+cp")
    if _cuda.on_cpu(x):
        return sync_corr_abs_plain(cfg, x, n_trials)
    x2 = x.reshape(-1, x.shape[-1])
    b, n = x2.shape
    _cuda.check(x2, "x", torch.complex64, (b, n))
    kt = device_table(_kernels_t, x.device, cfg)
    klen, nd = kt.shape
    out = torch.empty(b, n_trials, nd, dtype=torch.float32, device=x.device)
    if b and n_trials:
        _cuda.launch("sync_search", x.device, x2.data_ptr(), b, n,
                     kt.data_ptr(), klen, nd, out.data_ptr(), n_trials,
                     cfg.cp_len, cfg.stride, cfg.nfft, cfg.m_synch,
                     cfg.rx_b_len, float(cfg.m_synch * cfg.num_synch_bins))
        launches += 1
    return out.reshape(*x.shape[:-1], n_trials, nd)
