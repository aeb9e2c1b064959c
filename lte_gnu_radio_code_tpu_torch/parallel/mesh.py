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

"t" may also span several processes, one card each (the JAX package's
``multihost_mesh`` puts "t" on a host's chips): a mesh with a ``t_group``
stacks ``t_local`` of the "t" shards in each process, and the process at
position r of the group holds global shards r * t_local ... r * t_local +
t_local - 1.  Each collective then does its stacked op first and the group
op after it, in global shard order.  NCCL carries device tensors; over gloo
the tensors cross as CPU copies and the result returns to the mesh's
device.  A mesh without a ``t_group`` runs the stacked ops alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


class Mesh(NamedTuple):
    axis_names: tuple           # e.g. ("dp", "t")
    shape: dict                 # axis name -> global size, as jax's Mesh.shape
    device: torch.device        # where this process's shards lie
    group: object = None        # the process group that "dp" spans, or None
    t_group: object = None      # the process group that "t" spans, or None
    t_rank: int = 0             # this process's position in t_group
    t_local: int = 0            # the "t" shards each process of t_group stacks


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


def local_part(mesh: Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This process's shards of x, whose axis ``dim`` holds every shard of
    "t": x itself on a mesh without a "t" group, its ``t_local`` shards
    from ``t_rank * t_local`` on one with."""
    if mesh.t_group is None:
        return x
    return x.narrow(dim, mesh.t_rank * mesh.t_local, mesh.t_local)


# -- the collectives, on a shard axis ``dim`` of stacked shards --------------
# With ``mesh`` None, or a mesh without a "t" group, each is the stacked op.

def _group(mesh: Mesh | None):
    return None if mesh is None else mesh.t_group


def _to_wire(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x as the group's backend carries it: a CPU copy over gloo, the
    device tensor itself (contiguous) otherwise."""
    if dist.get_backend(mesh.t_group) == "gloo":
        return x.detach().to("cpu", copy=True).contiguous()
    return x.contiguous()


def _real(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def _all_reduce(y: torch.Tensor, op, mesh: Mesh | None) -> torch.Tensor:
    if _group(mesh) is None:
        return y
    w = _to_wire(mesh, y)
    dist.all_reduce(_real(w), op, group=mesh.t_group)
    return w.to(mesh.device)


def axis_index(n: int, device, mesh: Mesh | None = None) -> torch.Tensor:
    """``lax.axis_index``: the global numbers of this process's n stacked
    shards, 0..n-1 (t_rank * n + 0..n-1 in a "t" group)."""
    i = torch.arange(n, device=device)
    return i if _group(mesh) is None else i + mesh.t_rank * n


def ppermute(x: torch.Tensor, shift: int, dim: int,
             mesh: Mesh | None = None) -> torch.Tensor:
    """``lax.ppermute`` with perm s -> (s + shift) % n: shard s receives
    shard (s - shift) % n's block, cyclically.  In a "t" group the shards
    roll locally, and the one edge shard crosses to the neighbouring
    process (the last one's to the first, cyclically): shifts of +-1
    only, the bodies' halo exchanges; any other raises ``ValueError``."""
    y = torch.roll(x, shift, dim)
    if _group(mesh) is None:
        return y
    if shift not in (1, -1):
        raise ValueError(f"ppermute across processes takes a shift of +-1, "
                         f"not {shift}")
    g = mesh.t_group
    size = dist.get_world_size(g)
    edge, slot = (-1, 0) if shift == 1 else (0, -1)
    out = _to_wire(mesh, x.select(dim, edge))
    into = torch.empty_like(out)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, _real(out), dist.get_global_rank(
            g, (mesh.t_rank + shift) % size), g),
        dist.P2POp(dist.irecv, _real(into), dist.get_global_rank(
            g, (mesh.t_rank - shift) % size), g)])
    for r in reqs:
        r.wait()
    y.select(dim, slot).copy_(into)
    return y


def psum(x: torch.Tensor, dim: int, mesh: Mesh | None = None) -> torch.Tensor:
    """``lax.psum``: the sum over the shards."""
    return _all_reduce(x.sum(dim), dist.ReduceOp.SUM, mesh)


def pmin(x: torch.Tensor, dim: int, mesh: Mesh | None = None) -> torch.Tensor:
    """``lax.pmin``: the least value over the shards."""
    return _all_reduce(x.amin(dim), dist.ReduceOp.MIN, mesh)


def all_gather(x: torch.Tensor, dim: int,
               mesh: Mesh | None = None) -> torch.Tensor:
    """``lax.all_gather(tiled=True)``: the shards' blocks [..., n, m, ...]
    end to end in global shard order, [..., n*m, ...]."""
    dim %= x.dim()
    y = x.flatten(dim, dim + 1)
    if _group(mesh) is None:
        return y
    part = _to_wire(mesh, y.movedim(dim, 0))
    out = part.new_empty((dist.get_world_size(mesh.t_group) * part.shape[0],
                          *part.shape[1:]))
    dist.all_gather_into_tensor(_real(out), _real(part), group=mesh.t_group)
    return out.to(mesh.device).movedim(0, dim)
