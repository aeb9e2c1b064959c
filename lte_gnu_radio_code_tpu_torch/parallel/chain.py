"""The loopback chain on a (dp, t) mesh: frames on "dp", each frame's RX
sharded over "t".

Port of ``lte_gnu_radio_code_tpu/parallel/chain.py``.  TX, channel and
AWGN are ``models.chain.transmit`` (K1 and K3 over the whole batch, as
``chain_batch``); each received frame is zero-padded and cut into t
stacked shards, and the time-sharded RX body (``parallel/sharded.py``)
runs over every frame's shards at once: one K4 and one K2 launch a step,
whatever the batch and t.  Within one process "dp" only requires the
batch to split evenly; on a mesh from ``parallel/multihost.py`` each
process takes the rows of its place in the "dp" group, and frames need no
traffic between processes.  Where "t" spans processes too, the processes
of a "t" group take the same rows and run TX and channel on them each,
and the RX crosses the group inside each frame.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import chain
from ..models.rxofdm import plan_rx
from ..utils.params import OFDMConfig
from . import mesh as pmesh
from . import sharded


def local_rows(mesh: pmesh.Mesh, batch: int) -> slice:
    """The rows of a [batch, ...] input that this process takes: all of
    them in one process, on a multi-process mesh the part of its rank in
    the "dp" group (every process of a "t" group takes the same).  Raises
    where the batch does not split over dp."""
    dp = mesh.shape.get("dp", 1)
    if batch % dp:
        raise ValueError(f"batch {batch} does not split over dp = {dp}")
    if mesh.group is None:
        return slice(0, batch)
    rank, rows = dist.get_rank(mesh.group), batch // dp
    return slice(rank * rows, (rank + 1) * rows)


def make_sharded_chain(cfg: OFDMConfig, mesh: pmesh.Mesh):
    """fn(bits [B, num_bits], generator=None, noise=None) -> (ber, found,
    lock_ptr), each [B] (``chain.make_sharded_chain``); on a multi-process
    mesh each process gives its own rows (:func:`local_rows`) and
    ``multihost.gather_frames`` puts them together.  ``noise`` [B,
    frame_len + nfft - 1] is the global batch's, as ``bits``; a
    ``generator`` draws the noise of this process's frames (the processes
    of a "t" group must seed theirs alike).  The search
    and demod go through the kernels' wrappers, as ``chain_batch``'s do: K4
    and K2 on a CUDA device, their plain twins on the CPU.  Raises
    ``ValueError`` where a shard would be smaller than the halo."""
    n = cfg.frame_len + cfg.nfft - 1
    t_shards = mesh.shape["t"]
    sharded.check_shards(cfg, sharded.padded_len(cfg, n, t_shards) //
                         t_shards)
    _, num_patterns = plan_rx(cfg, n)
    h = chain.loopback_taps(cfg)

    def run(bits, generator=None, noise=None):
        bits = torch.as_tensor(bits, device=mesh.device)
        rows = local_rows(mesh, bits.shape[0])
        bits = bits[rows]
        if noise is not None:
            noise = torch.as_tensor(noise, device=mesh.device)[rows]
        rx = chain.transmit(cfg, h, bits, generator=generator, noise=noise)
        r = sharded.sharded_rx_frame(cfg, rx, mesh, num_patterns=num_patterns)
        return chain._ber(r.hard_bits, bits), r.found, r.lock_ptr

    return run
