"""Sharded continuous streaming: every chunk of an endless stream is cut
into shards on the mesh's "t" axis, and detections are deduplicated across
both chunk edges (the carried refractory state) and shard edges (one
trial-ordered selection over the gathered peaks).

Port of ``lte_gnu_radio_code_tpu/parallel/streaming.py``, for the
continuous multi-detection receiver and the legacy CFO/DSSS one.  A
chunk's shards lie stacked, [t, l_loc] (``parallel/mesh.py``); per chunk:

  1. each shard receives its left neighbour's trailing ``lag`` samples
     (shard 0 takes the carried history), so every trial's whole reach —
     sync windows and data symbols — is local;
  2. each shard searches its own trials: one K4 launch over the contiguous
     [t, lag + l_loc] rows (the legacy receiver's CFO x delay search is
     plain torch, as in ``ops/cfo.py``);
  3. the per-trial peaks, gathered in global trial order, go through one
     refractory selection (``ops/sync.py:refractory_table``) that
     continues the carried (last_det_ptr, any_det);
  4. each shard demodulates the detections whose trials it owns, in one
     call over every shard's [det_max] table (one K2 launch over
     [t*det_max*nd, nfft] rows, [t*det_max, nfft] for the legacy receiver),
     and the tables sum over the shards.

Chunked and sharded == the single-device receiver on the same chunks, and
== the whole-buffer receiver.  A step keeps static shapes and waits for
nothing on the host.

On a mesh whose "t" spans processes (``parallel/mesh.py``) every process
takes the whole chunk and works on its own shards of it; only the lag
samples of the halo, the gathered peaks and the summed tables cross the
group, and the carry (history, base, selection state) stays replicated on
every process.  Over gloo each collective copies to the host, so there a
step waits for the host; over NCCL it does not.
"""

from __future__ import annotations

import functools

import torch

from ..models import legacy_rx, stream_rx
from ..ops import cfo as cfo_ops
from ..ops import sync
from ..runtime.stream import (EagerStreamingRx, LegacyChunkOut,
                              LegacyStreamingRx, LegacyStreamState,
                              ReacqChunkOut, ReacqState, legacy_init,
                              legacy_lag, reacq_det_max, reacq_init,
                              reacq_lag)
from ..utils.params import OFDMConfig
from . import mesh as pmesh


def check_chunk(cfg: OFDMConfig, chunk_len: int, n_shards: int,
                lag: int) -> int:
    """The shard length of a chunk; ``ValueError`` where the chunk does not
    split into stride-aligned shards or a shard is shorter than the lag
    (``assert`` in the JAX package)."""
    stride = max(1, cfg.stride)
    if chunk_len % (n_shards * stride):
        raise ValueError(f"chunk_len {chunk_len} must be a multiple of "
                         f"n_shards * stride = {n_shards * stride}")
    l_loc = chunk_len // n_shards
    if lag > l_loc:
        raise ValueError(f"shard chunk ({l_loc}) smaller than the stream lag "
                         f"({lag}); use a larger chunk or fewer shards")
    return l_loc


def _left_halo(state, chunk: torch.Tensor, n_shards: int, lag: int,
               mesh: pmesh.Mesh):
    """(ext [t, lag + l_loc] of this process's t shards, their global
    numbers, each shard's global start of ext): shard s's chunk behind
    shard s-1's trailing lag samples, shard 0's behind the carried
    history."""
    x_local = pmesh.local_part(mesh, chunk.reshape(n_shards, -1), 0)
    i = pmesh.axis_index(x_local.shape[0], chunk.device, mesh)
    left = pmesh.ppermute(x_local[:, -lag:], 1, dim=-2, mesh=mesh)
    left = torch.where((i == 0)[:, None], state.hist, left)
    my_start = state.base + i * x_local.shape[-1] - lag
    return torch.cat([left, x_local], -1), i, my_start


def _owned(cfg: OFDMConfig, g_det, valid, base, lag: int, t_loc: int, i,
           my_start):
    """Which shard owns each detection (the one whose trials hold it):
    (mine [t, det_max], pointers relative to each shard's ext, 0 where not
    its own)."""
    stride = max(1, cfg.stride)
    trial_idx = torch.div(g_det - (base - lag) - cfg.cp_len, stride,
                          rounding_mode="floor")
    owner = torch.div(trial_idx, t_loc, rounding_mode="floor")
    mine = valid & (owner == i[:, None])
    return mine, torch.where(mine, g_det - my_start[:, None], 0)


def _reacq_body(cfg: OFDMConfig, state: ReacqState, chunk: torch.Tensor,
                n_real, *, mesh: pmesh.Mesh, n_shards: int, det_max: int):
    lag = reacq_lag(cfg)
    l_loc = check_chunk(cfg, chunk.shape[-1], n_shards, lag)
    stride = max(1, cfg.stride)
    dev = chunk.device

    # -- 1. left-halo exchange (shard 0 uses the carried history) ----------
    ext, i, my_start = _left_halo(state, chunk, n_shards, lag, mesh)

    # -- 2. local dense search ---------------------------------------------
    t_loc = l_loc // stride
    dmax_val, dmax_ind = stream_rx.detect_trials(cfg, ext, t_loc)
    local_ptrs = cfg.cp_len + stride * torch.arange(t_loc, device=dev)

    # -- 3. global trial-ordered refractory selection -----------------------
    vals = pmesh.all_gather(dmax_val, 0, mesh)
    inds = pmesh.all_gather(dmax_ind, 0, mesh)
    gptrs = pmesh.all_gather(my_start[:, None] + local_ptrs, 0, mesh)
    crossing = (vals > sync.gate_level(cfg)) & (gptrs >= cfg.cp_len)
    g_det, (delays, peaks), count, (last_ptr, any_det) = \
        sync.refractory_table(cfg, crossing, (inds, vals), det_max,
                              state.base - lag + cfg.cp_len,
                              state.last_det_ptr, state.any_det)
    valid = torch.arange(det_max, device=dev) < count

    # -- 4. per-shard demod of owned detections, summed over the shards -----
    mine, ptr_rel = _owned(cfg, g_det, valid, state.base, lag, t_loc, i,
                           my_start)
    real_end = state.real_end + n_real
    chans_i, ph_i, ok_i = stream_rx.demod_detections(
        cfg, ext, ptr_rel, delays.expand(ext.shape[0], -1), mine,
        real_end - my_start)
    phasors = pmesh.psum(ph_i, 0, mesh)

    new_state = ReacqState(hist=chunk[-lag:].clone(),
                           base=state.base + chunk.shape[-1],
                           real_end=real_end, last_det_ptr=last_ptr,
                           any_det=any_det)
    out = ReacqChunkOut(ptrs=torch.where(valid, g_det, -1), delays=delays,
                        peaks=peaks, valid=valid,
                        demod_ok=pmesh.psum(ok_i.to(torch.int32), 0,
                                            mesh) > 0,
                        chans=pmesh.psum(chans_i, 0, mesh), phasors=phasors,
                        hard_bits=stream_rx.hard_decide(cfg, phasors))
    return new_state, out


def make_sharded_reacq_step(cfg: OFDMConfig, chunk_len: int,
                            mesh: pmesh.Mesh, axis: str = "t",
                            det_max: int | None = None):
    """The sharded chunk step (``streaming.make_sharded_reacq_step``):
    (step, det_max) with step(state, chunk [chunk_len], n_real) -> (state,
    ReacqChunkOut).  Raises ``ValueError`` for a chunk that does not split
    (:func:`check_chunk`)."""
    n_shards = mesh.shape[axis]
    check_chunk(cfg, chunk_len, n_shards, reacq_lag(cfg))
    if det_max is None:
        det_max = reacq_det_max(cfg, chunk_len)
    return functools.partial(
        _reacq_body, cfg, mesh=mesh, n_shards=n_shards,
        det_max=det_max), det_max


class ShardedReacqStreamingRx(EagerStreamingRx):
    """The ``ReacqStreamingRx`` semantics (``push``, ``push_many``,
    ``finish`` and the npz checkpoints) with every chunk time-sharded over
    the mesh, on the mesh's device; each step runs eagerly
    (:class:`EagerStreamingRx`)."""

    def __init__(self, cfg: OFDMConfig, chunk_len: int, mesh: pmesh.Mesh,
                 axis: str = "t"):
        self.cfg = cfg
        self.chunk_len = chunk_len
        self.mesh = mesh
        self.device = mesh.device
        self.lag = reacq_lag(cfg)
        self._step, self.det_max = make_sharded_reacq_step(
            cfg, chunk_len, mesh, axis)
        self.state = reacq_init(cfg, self.device)


# ---------------------------------------------------------------------------
# The legacy CFO/DSSS receiver, sharded the same way
# ---------------------------------------------------------------------------


def _legacy_body(cfg: OFDMConfig, state: LegacyStreamState,
                 chunk: torch.Tensor, n_real, *, mesh: pmesh.Mesh,
                 n_shards: int, det_max: int, bank: torch.Tensor, dsss: int):
    lag = legacy_lag(cfg)
    l_loc = check_chunk(cfg, chunk.shape[-1], n_shards, lag)
    stride = max(1, cfg.stride)
    dev = chunk.device

    # 1. left-halo exchange (shard 0 uses the carried history)
    ext, i, my_start = _left_halo(state, chunk, n_shards, lag, mesh)

    # 2. local CFO x delay search, one candidate at a time
    t_loc = l_loc // stride
    dmax_val, delay_win, fo_win = cfo_ops.cfo_search_scan(cfg, ext, t_loc,
                                                          bank)
    local_ptrs = cfg.cp_len + stride * torch.arange(t_loc, device=dev)

    # 3. global trial-ordered refractory selection
    vals = pmesh.all_gather(dmax_val, 0, mesh)
    gptrs = pmesh.all_gather(my_start[:, None] + local_ptrs, 0, mesh)
    crossing = (vals > sync.gate_level(cfg)) & (gptrs >= cfg.cp_len)
    g_det, (delays, fo_sel, peaks), count, (last_ptr, any_det) = \
        sync.refractory_table(
            cfg, crossing, (pmesh.all_gather(delay_win, 0, mesh),
                            pmesh.all_gather(fo_win, 0, mesh), vals), det_max,
            state.base - lag + cfg.cp_len, state.last_det_ptr, state.any_det)
    valid = torch.arange(det_max, device=dev) < count

    # 4. per-shard demod of owned detections, summed over the shards
    mine, ptr_rel = _owned(cfg, g_det, valid, state.base, lag, t_loc, i,
                           my_start)
    real_end = state.real_end + n_real
    delays_i = delays.expand(ext.shape[0], -1)
    fo_i = fo_sel.expand(ext.shape[0], -1)
    det_spec = cfo_ops.spectra_at_detections(cfg, ext, ptr_rel, fo_i, bank)
    _, chans_i, _ = sync.estimate_channel(cfg, det_spec,
                                          delays_i.to(torch.int64))
    chans_i = chans_i * mine[..., None]
    data_off = cfg.m_synch * cfg.rx_b_len
    ok_i = mine & (g_det + data_off + cfg.nfft <= real_end)
    ph_i = legacy_rx.demod_after_detections(
        cfg, ext, torch.where(ok_i, ptr_rel + data_off, 0), ok_i, delays_i,
        fo_i, chans_i, bank)
    phasors = pmesh.psum(ph_i, 0, mesh)

    new_state = LegacyStreamState(
        hist=chunk[-lag:].clone(), base=state.base + chunk.shape[-1],
        real_end=real_end, last_det_ptr=last_ptr, any_det=any_det)
    out = LegacyChunkOut(
        ptrs=torch.where(valid, g_det, -1), delays=delays, peaks=peaks,
        fo_idx=fo_sel, valid=valid,
        demod_ok=pmesh.psum(ok_i.to(torch.int32), 0, mesh) > 0,
        chans=pmesh.psum(chans_i, 0, mesh), phasors=phasors,
        despread=cfo_ops.dsss_despread(phasors, dsss))
    return new_state, out


def make_sharded_legacy_step(cfg: OFDMConfig, chunk_len: int,
                             mesh: pmesh.Mesh, axis: str = "t",
                             det_max: int | None = None, fo_range=(0.0,),
                             dsss: int = 1):
    """The sharded legacy chunk step (``streaming.make_sharded_legacy_step``):
    (step, det_max) with step(state, chunk [chunk_len], n_real) -> (state,
    LegacyChunkOut); the demod is K2."""
    n_shards = mesh.shape[axis]
    check_chunk(cfg, chunk_len, n_shards, legacy_lag(cfg))
    if det_max is None:
        det_max = reacq_det_max(cfg, chunk_len)
    return functools.partial(
        _legacy_body, cfg, mesh=mesh, n_shards=n_shards, det_max=det_max,
        bank=cfo_ops.bank_on(cfg, fo_range, mesh.device),
        dsss=dsss), det_max


class ShardedLegacyStreamingRx(LegacyStreamingRx):
    """The ``LegacyStreamingRx`` semantics with every chunk time-sharded
    over the mesh, on the mesh's device."""

    def __init__(self, cfg: OFDMConfig, chunk_len: int, mesh: pmesh.Mesh,
                 axis: str = "t", fo_range=(0.0,), dsss: int = 1):
        self.cfg = cfg
        self.chunk_len = chunk_len
        self.mesh = mesh
        self.device = mesh.device
        self.lag = legacy_lag(cfg)
        self._step, self.det_max = make_sharded_legacy_step(
            cfg, chunk_len, mesh, axis, fo_range=fo_range, dsss=dsss)
        self.state = legacy_init(cfg, self.device)
