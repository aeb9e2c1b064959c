"""Split RX pipeline in torch: the sync-index finder and the channel
estimate + demod as two stages.

Port of ``lte_gnu_radio_code_tpu/models/split.py`` (``find_synch_index``,
``channel_estimate_demod``, ``make_split_rx``): stage A passes the signal
through and gives the detection table beside it; stage B takes a lock from
that table, estimates the channel there and equalises every pattern block.
Together they equal the monolithic ``rxofdm.rx_frame``.  QPSK, as in the
JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..kernels import equalize
from ..ops import modulation, sync
from ..utils.device import as_samples, resolve_device
from ..utils.params import OFDMConfig
from . import stream_rx
from .rxofdm import plan_rx


class SynchIndexResult(NamedTuple):
    passthrough: torch.Tensor  # the input signal, unchanged
    ptrs: torch.Tensor         # [max_det] int32
    delays: torch.Tensor       # [max_det] int32
    peaks: torch.Tensor        # [max_det] float32
    count: torch.Tensor


def find_synch_index(cfg: OFDMConfig, x: torch.Tensor, n_trials: int,
                     max_det: int = 100) -> SynchIndexResult:
    """Stage A only: the search (K4) and the multi-detection table
    (``split.py:find_synch_index``)."""
    dmax_val, dmax_ind = stream_rx.detect_trials(cfg, x, n_trials)
    ptrs, (delays, peaks), count = sync.refractory_detect(
        cfg, dmax_val, (dmax_ind, dmax_val), max_det)
    return SynchIndexResult(x, ptrs, delays, peaks.to(torch.float32), count)


class ChanEstResult(NamedTuple):
    phasors: torch.Tensor      # [num_patterns * nd, num_data_bins]
    hard_bits: torch.Tensor
    chan_freq: torch.Tensor    # [nfft]


def channel_estimate_demod(cfg: OFDMConfig, x: torch.Tensor, lock_ptr,
                           delay_idx, num_patterns: int) -> ChanEstResult:
    """Stage B given a sync lock (``split.py:channel_estimate_demod``): the
    channel estimate at the lock, then every pattern block equalised by K2,
    as in ``rx_frame``."""
    lock_ptr = torch.as_tensor(lock_ptr, device=x.device)
    trial = torch.div(lock_ptr - cfg.cp_len, max(1, cfg.stride),
                      rounding_mode="floor")
    spec = sync.sync_spectrum_at(cfg, x, trial)
    _, chan_full, _ = sync.estimate_channel(cfg, spec, delay_idx)
    phasors = equalize.equalize_data_symbols(cfg, x, lock_ptr, delay_idx,
                                             chan_full, num_patterns)
    hard, _, _ = modulation.qpsk_llr(phasors)
    return ChanEstResult(phasors, hard, chan_full)


def make_split_rx(cfg: OFDMConfig, n_samples: int, max_det: int = 100,
                  device=None):
    """(find_synch_index, channel_estimate_demod) bound to a buffer length
    (``split.py:make_split_rx``).  Both take their samples to the CUDA
    device, or to ``device``."""
    device = resolve_device(device)
    n_trials, num_patterns = plan_rx(cfg, n_samples)
    f1 = functools.partial(find_synch_index, cfg, n_trials=n_trials,
                           max_det=max_det)
    f2 = functools.partial(channel_estimate_demod, cfg,
                           num_patterns=num_patterns)
    return (lambda x: f1(as_samples(x, device)),
            lambda x, lock_ptr, delay_idx: f2(as_samples(x, device),
                                              lock_ptr, delay_idx))
