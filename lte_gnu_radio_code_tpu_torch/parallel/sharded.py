"""Time-sharded RX: one sample buffer cut into contiguous shards on the
mesh's "t" axis, demodulated with results equal to the single-device RX.

Port of ``lte_gnu_radio_code_tpu/parallel/sharded.py``.  The shards of a
buffer lie stacked, x_local [..., t, local] (``parallel/mesh.py``), and the
body follows the JAX one step by step:

  1. each shard receives its right neighbour's leading ``halo`` samples
     (the last shard shard 0's, cyclically, as the JAX ``ppermute``), so
     every sync trial and every data block that straddles a shard edge is
     resolved locally;
  2. the sync search runs on every shard's own trials: one K4 launch over
     the contiguous [..., t, local + halo] rows on a CUDA device;
  3. the first lock is the least key over the shards (``pmin``), and the
     winner's delay, peak and channel estimate are taken from its row;
  4. each shard demodulates the pattern blocks whose base pointer lies in
     its chunk: one K2 launch over every shard's block windows with one
     coefficient row (derotation x MMSE gain x ownership) a window; the
     rows scatter into the global phasor table and sum over the shards.

Halo: a sync trial at relative offset cp + j*stride reads up to
(m_synch - 1)*(nfft + cp) + nfft further, a data block based at the chunk
edge up to (pattern_len - 1)*(nfft + cp) + nfft; the halo is the larger,
and only those samples cross to the neighbour.

On a mesh whose "t" spans processes (``parallel/mesh.py``) each process
takes its own shards of the padded buffer (:func:`shard`), the
collectives cross the group, and every output is replicated on each
process of the group, as the JAX ``out_specs`` give it.  The merges stay
exact: one shard owns each nonzero entry of every sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import stream_rx
from ..models.rxofdm import RxResult, demap, plan_rx
from ..kernels import equalize
from ..ops import sync
from ..utils.device import as_samples
from ..utils.params import OFDMConfig
from ..utils.tables import device_table
from . import mesh as pmesh

INT_MAX = 2 ** 31 - 1


def sync_halo(cfg: OFDMConfig) -> int:
    return cfg.cp_len + (cfg.m_synch - 1) * cfg.rx_b_len + cfg.nfft


def data_halo(cfg: OFDMConfig) -> int:
    return (cfg.pattern_len - 1) * cfg.rx_b_len + cfg.nfft


def halo_size(cfg: OFDMConfig) -> int:
    return max(sync_halo(cfg), data_halo(cfg))


def padded_len(cfg: OFDMConfig, n: int, n_shards: int) -> int:
    """Global buffer length padded so that each shard is a stride
    multiple."""
    quantum = n_shards * max(1, cfg.stride)
    return -(-n // quantum) * quantum


def check_shards(cfg: OFDMConfig, local: int) -> None:
    """A shard must hold its neighbour's halo (``assert`` in the JAX body)."""
    if halo_size(cfg) > local:
        raise ValueError(f"shard chunk ({local}) smaller than halo "
                         f"({halo_size(cfg)}); use fewer shards")


def _local_rx(cfg: OFDMConfig, x_local: torch.Tensor, *, n_global: int,
              num_patterns: int,
              mesh: pmesh.Mesh | None = None) -> RxResult:
    """The body over this process's shards at once: x_local [..., t,
    local] (the leading dims are frames; t the shards this process stacks
    on ``mesh``) -> RxResult of each frame, as the
    single-device ``rxofdm.rx_frame`` gives it without a pilot grid (as
    the JAX body, every data symbol takes the synch symbols' channel
    estimate).  The search is K4 and the demod K2, as in
    ``models/stream_rx.py``.  Where no trial
    crosses the gate, the lock pointer is trial 0's, and the delay, peak,
    channel and phasors are zero."""
    n_shards, local = x_local.shape[-2:]
    check_shards(cfg, local)
    dev = x_local.device
    stride = max(1, cfg.stride)
    i = pmesh.axis_index(n_shards, dev, mesh)
    a0 = i * local                                   # each chunk's global start

    # -- 1. halo exchange: the right neighbour's first `halo` samples --------
    nbr = pmesh.ppermute(x_local[..., :halo_size(cfg)], -1, dim=-2,
                         mesh=mesh)
    ext = torch.cat([x_local, nbr], -1)

    # -- 2. local sync search -------------------------------------------------
    t_per = local // stride                          # trials per shard
    dmax_val, dmax_ind = stream_rx.detect_trials(cfg, ext, t_per)
    p_global = i[:, None] * t_per + torch.arange(t_per, device=dev)
    crossing = (dmax_val > sync.gate_level(cfg)) & (
        p_global < sync.n_trials_for(cfg, n_global))

    # -- 3. global first-lock merge ------------------------------------------
    found_local = crossing.any(-1)                   # [..., t]
    first_j = crossing.to(torch.int32).argmax(-1)    # [..., t]
    key = torch.where(found_local, i * t_per + first_j, INT_MAX)
    gmin = pmesh.pmin(key, -1, mesh)
    found = gmin < INT_MAX
    is_winner = found_local & (key == gmin[..., None])
    gmin = torch.where(found, gmin, 0)
    lock_ptr = cfg.cp_len + cfg.stride * gmin

    def at_first(v):
        return v.gather(-1, first_j[..., None])[..., 0]

    delay_idx = pmesh.psum(torch.where(is_winner, at_first(dmax_ind), 0), -1,
                           mesh)
    peak = pmesh.psum(torch.where(is_winner, at_first(dmax_val), 0.0), -1,
                      mesh)
    # the channel from the winner's spectrum alone: the JAX body's psum of
    # winner-weighted estimates, where every other shard adds zero
    win_shard = is_winner.to(torch.int32).argmax(-1)[..., None]
    ext_w = ext.gather(-2, win_shard[..., None].expand(
        *ext.shape[:-2], 1, ext.shape[-1]))[..., 0, :]
    spec = sync.sync_spectrum_at(cfg, ext_w,
                                 first_j.gather(-1, win_shard)[..., 0])
    if mesh is not None and mesh.t_group is not None:
        # the winner's process alone holds its row: its spectrum crosses
        # (where none won, the estimate is zeroed below either way)
        spec = pmesh.psum(torch.where(is_winner.any(-1, keepdim=True), spec,
                                      0)[..., None, :], -2, mesh)
    _, chan_full, cir = sync.estimate_channel(cfg, spec, delay_idx)
    chan_full, cir = (v * found[..., None] for v in (chan_full, cir))

    # -- 4. data demod: the blocks based inside each chunk -------------------
    nd = cfg.synch_dat[1]
    block = cfg.pattern_len * cfg.rx_b_len
    k_slots = local // block + 2
    rel_lock = lock_ptr[..., None] - a0              # [..., t]
    # floored, as the JAX package's // of a negative numerator
    k0 = (-torch.div(rel_lock, block, rounding_mode="floor")).clamp_min(0)
    k = k0[..., None] + torch.arange(k_slots, device=dev)   # [..., t, slots]
    b_k = rel_lock[..., None] + k * block            # relative to the chunk
    own = ((b_k >= 0) & (b_k < local) & (k < num_patterns) &
           found[..., None, None])
    win = sync.windows_at(ext, torch.where(own, b_k, 0), device_table(
        sync.data_window_offsets, dev, cfg, 1))     # [..., t, slots, nd, nfft]
    coeff = equalize.combined_coeff(cfg, delay_idx, chan_full)
    rows = coeff[..., None, None, :] * own[..., None]       # [..., t, slots, B]
    vals = stream_rx.demod_rows(cfg, win, rows[..., None, :])

    # scatter the owned rows into [num_patterns] (others into a spare row
    # that is cut off), then the sum over shards: one shard owns each block
    tgt = torch.where(own, k, num_patterns)
    ph = vals.new_zeros(*vals.shape[:-4], n_shards, num_patterns + 1, nd,
                        cfg.num_data_bins)
    ph = ph.scatter(-3, tgt[..., None, None].expand(vals.shape), vals)
    phasors = pmesh.psum(ph[..., :num_patterns, :, :], -4, mesh).reshape(
        *ph.shape[:-4], num_patterns * nd, cfg.num_data_bins)

    h_data = chan_full[..., sync._bins_on(dev, cfg.nfft, cfg.num_data_bins)]
    phasors, hard, llr0, llr1 = demap(cfg, phasors, h_data)
    return RxResult(phasors, hard, llr0, llr1, lock_ptr, delay_idx, peak,
                    found, cir)


def shard(cfg: OFDMConfig, x: torch.Tensor, n_shards: int,
          mesh: pmesh.Mesh | None = None) -> torch.Tensor:
    """x [..., n] zero-padded to :func:`padded_len` and cut into
    [..., n_shards, local] contiguous shards; on a mesh whose "t" spans
    processes, this process's [..., t_local, local] of them."""
    n = x.shape[-1]
    x = F.pad(x, (0, padded_len(cfg, n, n_shards) - n))
    x = x.reshape(*x.shape[:-1], n_shards, -1)
    return x if mesh is None else pmesh.local_part(mesh, x, -2)


def sharded_rx_frame(cfg: OFDMConfig, x: torch.Tensor, mesh: pmesh.Mesh,
                     axis: str = "t",
                     num_patterns: int | None = None) -> RxResult:
    """Demodulate a sample buffer x [n] (or one per frame, [..., n])
    sharded over mesh axis ``axis`` (``sharded.sharded_rx_frame``)."""
    n = x.shape[-1]
    if num_patterns is None:
        _, num_patterns = plan_rx(cfg, n)
    x_local = shard(cfg, as_samples(x, mesh.device), mesh.shape[axis], mesh)
    return _local_rx(cfg, x_local, n_global=n, num_patterns=num_patterns,
                     mesh=mesh)


def make_sharded_rx(cfg: OFDMConfig, n_samples: int, mesh: pmesh.Mesh,
                    axis: str = "t"):
    """The sharded RX bound to a buffer length
    (``sharded.make_sharded_rx``): fn(x) takes the samples (a tensor or
    anything numpy takes) to the mesh's device.  Raises ``ValueError`` where
    a shard would be smaller than the halo."""
    _, num_patterns = plan_rx(cfg, n_samples)
    n_shards = mesh.shape[axis]
    check_shards(cfg, padded_len(cfg, n_samples, n_shards) // n_shards)

    def run(x):
        if x.shape[-1] != n_samples:
            raise ValueError(f"buffer of {x.shape[-1]} samples, the RX was "
                             f"made for {n_samples}")
        return sharded_rx_frame(cfg, x, mesh, axis, num_patterns)

    return run
