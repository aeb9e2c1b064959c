"""The full loopback chain in torch: bits -> TX -> multipath channel ->
AWGN -> RX -> bits.

Port of ``lte_gnu_radio_code_tpu/models/chain.py`` (``chain_step``,
``make_chain``) and of the whole-batch step ``chain_batch`` that the JAX
package's ``bench.py`` times, moved here so the port owns its main path.
Noise comes from an explicit ``torch.Generator`` or a given noise tensor.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import channel_conv
from ..ops import channel as chan_ops
from ..utils.params import OFDMConfig
from . import rxofdm, txofdm


class ChainResult(NamedTuple):
    hard_bits: torch.Tensor
    ber: torch.Tensor
    phasors: torch.Tensor
    lock_ptr: torch.Tensor
    delay_idx: torch.Tensor
    found: torch.Tensor


class BatchChainResult(NamedTuple):
    ber: torch.Tensor            # [B]
    found: torch.Tensor          # [B]
    hard_bits: torch.Tensor      # [B, num_bits]
    lock_ptr: torch.Tensor       # [B]
    delay_idx: torch.Tensor      # [B]


def _ber(hard: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    nb = min(hard.shape[-1], bits.shape[-1])
    return (hard[..., :nb] != bits[..., :nb]).to(torch.float32).mean(-1)


def chain_step(cfg: OFDMConfig, bits: torch.Tensor, h: np.ndarray,
               n_trials: int, num_patterns: int, *,
               generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None,
               **rx_kwargs) -> ChainResult:
    """One frame end to end (``chain.py:chain_step``); rx_kwargs forward
    to ``rxofdm.rx_frame``."""
    tx = txofdm.tx_frame(cfg, bits)
    rx_clean = chan_ops.apply_channel(tx, h, max_impulse=cfg.nfft)
    sig_pow = ((tx - tx.mean()).abs() ** 2).mean()      # np.var of the TX
    rx = chan_ops.awgn(cfg, rx_clean, sig_pow, generator=generator,
                       noise=noise)
    r = rxofdm.rx_frame(cfg, rx, n_trials, num_patterns, **rx_kwargs)
    return ChainResult(r.hard_bits, _ber(r.hard_bits, bits), r.phasors,
                       r.lock_ptr, r.delay_idx, r.found)


def loopback_taps(cfg: OFDMConfig) -> np.ndarray:
    """The chain's CIR: the config's channel (AWGN runs the ideal one)."""
    return chan_ops.channel_taps(
        cfg.channel if cfg.channel != "AWGN" else "Ideal")


def make_chain(cfg: OFDMConfig, **rx_kwargs):
    """chain_step bound to the config's canonical frame length
    (``chain.py:make_chain``).  ``perfect_chan_est`` without ``genie_h``
    uses the chain's own taps."""
    n_samples = cfg.frame_len + cfg.nfft - 1
    n_trials, num_patterns = rxofdm.plan_rx(cfg, n_samples)
    h = loopback_taps(cfg)
    if rx_kwargs.get("perfect_chan_est") and "genie_h" not in rx_kwargs:
        rx_kwargs["genie_h"] = np.concatenate(
            [h, np.zeros(cfg.nfft - len(h), h.dtype)])
    return functools.partial(chain_step, cfg, h=h, n_trials=n_trials,
                             num_patterns=num_patterns, **rx_kwargs)


def chain_batch(cfg: OFDMConfig, h: np.ndarray, n_trials: int,
                num_patterns: int, bits: torch.Tensor, *,
                generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None,
                plain: bool = False) -> BatchChainResult:
    """Whole-batch chain step, the form ``bench.py:chain_batch`` times on
    the all-kernel path: bits [B, num_bits] -> per-frame BER and lock.

    TX runs as one K1 launch over every symbol of the batch, the channel
    as one K3 launch (any CIR of <= 16 taps), AWGN per frame with a
    per-frame signal power, and RX through ``rxofdm.rx_frames_batch`` (K4
    and K2).  ``plain`` swaps every kernel for its plain twin, with TX
    through torch.fft."""
    tx = txofdm.tx_frames(cfg, bits, path=None if plain else "kernel")
    if plain or len(h) > channel_conv.MAX_TAPS:
        clean = chan_ops.apply_channel(tx, h, max_impulse=cfg.nfft)
    else:
        clean = channel_conv.apply_channel_frames(tx, h, cfg.nfft)
    sig_pow = ((tx - tx.mean(1, keepdim=True)).abs() ** 2).mean(1)
    rxs = chan_ops.awgn(cfg, clean, sig_pow[:, None], generator=generator,
                        noise=noise)
    r = rxofdm.rx_frames_batch(cfg, rxs, n_trials, num_patterns,
                               plain=plain)
    return BatchChainResult(_ber(r.hard_bits, bits), r.found, r.hard_bits,
                            r.lock_ptr, r.delay_idx)
