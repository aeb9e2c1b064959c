"""The full loopback chain in torch: bits -> TX -> multipath channel ->
AWGN -> RX -> bits.

Port of ``lte_gnu_radio_code_tpu/models/chain.py`` (``chain_step``,
``make_chain``, ``ber_sweep``) and of the whole-batch step ``chain_batch``
that the JAX package's ``bench.py`` times, moved here so the port owns its
main path.  Every modulation and pilot grid runs through both.  Noise comes
from an explicit ``torch.Generator`` or a given noise tensor.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..kernels import channel_conv
from ..ops import channel as chan_ops
from ..utils import profiling
from ..utils.device import resolve_device
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
    phasors: torch.Tensor        # [B, num_data_symb, num_data_bins]


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


def transmit(cfg: OFDMConfig, h: np.ndarray, bits: torch.Tensor, *,
             generator: torch.Generator | None = None,
             noise: torch.Tensor | None = None) -> torch.Tensor:
    """The TX and channel half of :func:`chain_batch`: bits [B, num_bits]
    -> received samples [B, frame_len + nfft - 1].  TX is one K1 launch
    over every symbol of the batch, the channel one K3 launch (any CIR of
    <= 16 taps; a longer one in torch), AWGN per frame with a per-frame
    signal power.  Span ``ofdm.tx``."""
    with profiling.span("ofdm.tx"):
        tx = txofdm.tx_frames(cfg, bits)
        if len(h) > channel_conv.MAX_TAPS:
            clean = chan_ops.apply_channel(tx, h, max_impulse=cfg.nfft)
        else:
            clean = channel_conv.apply_channel_frames(tx, h, cfg.nfft)
        sig_pow = ((tx - tx.mean(1, keepdim=True)).abs() ** 2).mean(1)
        return chan_ops.awgn(cfg, clean, sig_pow[:, None],
                             generator=generator, noise=noise)


def _chain_batch_eager(cfg: OFDMConfig, h: np.ndarray, n_trials: int,
                       num_patterns: int, bits: torch.Tensor, *,
                       generator: torch.Generator | None = None,
                       noise: torch.Tensor | None = None) -> BatchChainResult:
    """The body of one :func:`chain_batch` step, run op by op: what a
    graph captures and what every step that does not replay one runs."""
    rxs = transmit(cfg, h, bits, generator=generator, noise=noise)
    r = rxofdm.rx_frames_batch(cfg, rxs, n_trials, num_patterns)
    return BatchChainResult(_ber(r.hard_bits, bits), r.found, r.hard_bits,
                            r.lock_ptr, r.delay_idx, r.phasors)


class _Inputs(NamedTuple):
    pool: tuple                 # the memory pool of this shape's graphs
    bits: torch.Tensor          # the bits buffer they read
    noise: torch.Tensor         # the noise buffer they read


class _ChainGraph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: _Inputs
    out: BatchChainResult       # the graph's outputs, rewritten each replay
    launched: dict              # kernels.launch_state() keys: a replay's


_GRAPHS_MAX = 16
_graphs: collections.OrderedDict = collections.OrderedDict()  # LRU
_inputs: dict = {}              # a key's last entry -> _Inputs


def _graph_key(cfg: OFDMConfig, h: np.ndarray, n_trials: int,
               num_patterns: int, bits: torch.Tensor,
               noise: torch.Tensor) -> tuple:
    """Everything a captured step bakes in: the configuration (its
    ``snr_db`` among the Python floats the step reads), the taps, the
    plan, and the inputs' shapes, dtypes and device (the last entry)."""
    h = np.asarray(h)
    return (cfg, h.dtype.str, h.shape, h.tobytes(), n_trials, num_patterns,
            (bits.shape, bits.dtype, noise.shape, noise.dtype, bits.device))


def _capture(cfg: OFDMConfig, h: np.ndarray, n_trials: int,
             num_patterns: int, bits: torch.Tensor, noise: torch.Tensor,
             key: tuple) -> _ChainGraph:
    """The graph of one step on the input buffers of the key's shape (made
    from bits and noise at that shape's first capture), in that shape's
    memory pool.  Two warm-up steps on a side stream first make every
    table, FFT plan and workspace the step uses.  The launch counters end
    as they began; what the capture launched is what each replay adds."""
    inputs = _inputs.get(key[-1])
    if inputs is None:
        inputs = _inputs[key[-1]] = _Inputs(
            torch.cuda.graph_pool_handle(),
            bits.clone(memory_format=torch.contiguous_format),
            noise.clone(memory_format=torch.contiguous_format))
    step = functools.partial(_chain_batch_eager, cfg, h, n_trials,
                             num_patterns, inputs.bits, noise=inputs.noise)
    before = kernels.launch_state()
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    warm = kernels.launch_state()
    with torch.cuda.graph(graph, pool=inputs.pool):
        out = step()
    after = kernels.launch_state()
    kernels.add_launches({k: before[k] - n for k, n in after.items()})
    return _ChainGraph(graph, inputs, out, {k: n - warm[k]
                                            for k, n in after.items()
                                            if n != warm[k]})


def _replay(cfg: OFDMConfig, h: np.ndarray, n_trials: int,
            num_patterns: int, bits: torch.Tensor,
            noise: torch.Tensor) -> BatchChainResult:
    """One step as a replay of the key's graph (captured at its first
    step; the least recently used of more than _GRAPHS_MAX graphs goes):
    the inputs copied into its buffers, its outputs cloned, since the next
    replay of any graph of the shape may rewrite them."""
    key = _graph_key(cfg, h, n_trials, num_patterns, bits, noise)
    g = _graphs.get(key)
    if g is None:
        with torch.cuda.device(bits.device):
            g = _capture(cfg, h, n_trials, num_patterns, bits, noise, key)
        _graphs[key] = g
        while len(_graphs) > _GRAPHS_MAX:
            old = _graphs.popitem(last=False)[0][-1]
            if all(k[-1] != old for k in _graphs):
                del _inputs[old]
    _graphs.move_to_end(key)
    g.inputs.bits.copy_(bits)
    g.inputs.noise.copy_(noise)
    g.graph.replay()            # on the current stream of the graph's device
    kernels.add_launches(g.launched)
    if profiling.recording():
        profiling.count("ofdm.graph_steps", 1)
    return BatchChainResult(*(f.clone() for f in g.out))


def chain_batch(cfg: OFDMConfig, h: np.ndarray, n_trials: int,
                num_patterns: int, bits: torch.Tensor, *,
                generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None) -> BatchChainResult:
    """Whole-batch chain step, the form ``bench.py:chain_batch`` times:
    bits [B, num_bits] -> per-frame BER and lock.

    TX and channel through :func:`transmit` (K1 and K3), and RX through
    ``rxofdm.rx_frames_batch`` (K4 and K2), for any modulation and pilot
    grid: the kernels on a CUDA device, their plain twins on the CPU.

    A step on a CUDA device given ``noise=`` (and so a pure function of
    bits and noise), outside another capture, with a CIR K3 takes, runs as
    one replay of a CUDA graph of the step, captured at the first step of
    its configuration, taps, plan and input shapes: a launch a step in
    place of some 130, the same kernels at the same precision on the same
    data, outputs cloned from the graph's, the kernels' launch counters
    raised by what the capture launched.  The graphs of one input shape
    share a memory pool and one bits and one noise buffer, so their steps
    go on one stream, one after another.  Every other step (a
    ``generator=``, the CPU) runs eagerly.  Span ``ofdm.chain_step``, the
    root of the stages (a replayed step runs none of their Python); the
    BER is in its own time.  Counter ``ofdm.graph_steps``: 1 a replayed
    step, 0 an eager one."""
    with profiling.span("ofdm.chain_step"):
        if (bits.is_cuda and noise is not None and generator is None and
                noise.device == bits.device and
                len(h) <= channel_conv.MAX_TAPS and
                not torch.cuda.is_current_stream_capturing()):
            return _replay(cfg, h, n_trials, num_patterns, bits, noise)
        profiling.count("ofdm.graph_steps", 0)
        return _chain_batch_eager(cfg, h, n_trials, num_patterns, bits,
                                  generator=generator, noise=noise)


def ber_sweep(cfg: OFDMConfig, snr_dbs, seeds=range(4), device=None
              ) -> dict[float, float]:
    """BER against SNR (``chain.py:ber_sweep``): {snr_db: mean BER over the
    seeds}.  Each seed is one frame of numpy-seeded bits through
    :func:`chain_batch` with a ``torch.Generator`` seeded alike: K1-K4 on
    the CUDA device, which is where it runs unless ``device`` says "cpu"."""
    device = resolve_device(device)
    out = {}
    for snr in snr_dbs:
        c = dataclasses.replace(cfg, snr_db=float(snr)).validate()
        n_trials, num_patterns = rxofdm.plan_rx(c, c.frame_len + c.nfft - 1)
        h = loopback_taps(c)
        bers = []
        for s in seeds:
            bits = torch.as_tensor(np.random.default_rng(s).integers(
                0, 2, (1, c.num_bits), dtype=np.int32), device=device)
            gen = torch.Generator(device=device).manual_seed(s)
            bers.append(chain_batch(c, h, n_trials, num_patterns, bits,
                                    generator=gen).ber[0])
        out[float(snr)] = float(torch.stack(bers).mean())
    return out
