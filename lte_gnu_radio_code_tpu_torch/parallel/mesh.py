"""The mesh of the sharded runtime, and its collectives on stacked shards.

Port of ``lte_gnu_radio_code_tpu/parallel/mesh.py``.  The JAX package runs
``shard_map`` over a ``jax.sharding.Mesh`` with the named axes

  "dp" — data parallel over independent frames,
  "t"  — time parallel within one frame's or one chunk's samples, with a
         halo exchanged between neighbouring shards.

Here the shards of one process lie on one device, stacked: a sharded
buffer is one tensor [..., t, local], and each collective of the JAX
bodies is a tensor operation on that shard axis (:func:`ppermute`,
:func:`psum`, :func:`pmin`, :func:`all_gather`, :func:`axis_index`).  So a
kernel gets every shard's rows in one launch, however many shards there
are.  "dp" across processes is ``torch.distributed``
(``parallel/multihost.py``): a mesh built there carries the process group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import resolve_device


class Mesh(NamedTuple):
    axis_names: tuple           # e.g. ("dp", "t")
    shape: dict                 # axis name -> size, as jax's Mesh.shape
    device: torch.device        # where this process's shards lie
    group: object = None        # the process group that "dp" spans, or None


def make_mesh(n: int, dp: int = 1, axis_names=("dp", "t"),
              device=None) -> Mesh:
    """A (dp, t) mesh of n shards in this process (``mesh.make_mesh``):
    t = n // dp.  The shards lie on ``device`` (None: the CUDA device,
    which raises where there is none)."""
    if n < 1 or dp < 1 or n % dp:
        raise ValueError(f"{n} shards do not split into dp = {dp} rows")
    return Mesh(tuple(axis_names), dict(zip(axis_names, (dp, n // dp))),
                resolve_device(device))


def time_mesh(n: int, device=None) -> Mesh:
    """A 1-D mesh of n shards on the time axis (``mesh.time_mesh``)."""
    if n < 1:
        raise ValueError(f"a mesh of {n} shards")
    return Mesh(("t",), {"t": n}, resolve_device(device))


# -- the collectives, on a shard axis ``dim`` of stacked shards --------------

def axis_index(n: int, device) -> torch.Tensor:
    """``lax.axis_index``: the shard numbers 0..n-1."""
    return torch.arange(n, device=device)


def ppermute(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    """``lax.ppermute`` with perm s -> (s + shift) % n: shard s receives
    shard (s - shift) % n's block, cyclically."""
    return torch.roll(x, shift, dim)


def psum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``lax.psum``: the sum over the shards."""
    return x.sum(dim)


def pmin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``lax.pmin``: the least value over the shards."""
    return x.amin(dim)


def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``lax.all_gather(tiled=True)``: the shards' blocks [..., n, m, ...]
    end to end in shard order, [..., n*m, ...]."""
    return x.flatten(dim, dim + 1)
