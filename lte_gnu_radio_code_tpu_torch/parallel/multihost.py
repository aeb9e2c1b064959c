"""Multi-process runs: the frame axis "dp" across processes, and "t"
across the processes of a host.

Port of ``lte_gnu_radio_code_tpu/parallel/multihost.py``.  Every process
runs the same program and calls :func:`init_distributed` first; one
process drives one card.  The mesh of :func:`multihost_mesh` puts "dp"
across the processes and stacks the "t" shards on each process's device
(``parallel/mesh.py``), or, with ``t_procs`` > 1, spreads "t" over
``t_procs`` processes of a host as the JAX package's mesh spreads it over a
host's chips: "dp" then spans the hosts, and the halo exchange and the
merges of the sharded bodies cross between a host's cards.  Frames on
"dp" need no traffic between processes inside the chain
(``parallel/chain.py``): only the results cross the "dp" group
(:func:`gather_frames`), and a barrier ends the run.

On a single process, without a coordinator, this degrades gracefully: no
process group, dp = 1.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from . import mesh as pmesh


def local_card(process_id: int) -> int:
    """The card of its host that a process drives: LOCAL_RANK where the
    launcher sets it (torchrun does), else the process number modulo the
    host's card count (processes numbered host by host)."""
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return int(local)
    return process_id % torch.cuda.device_count()


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device=None) -> bool:
    """``torch.distributed.init_process_group`` over
    ``tcp://<coordinator>`` (host:port), with the JAX function's env-var
    fallbacks JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID.
    The backend is "nccl" where this process's device (None: the CUDA
    device) is a CUDA device and "gloo" otherwise, unless ``backend`` names
    one.  On a CUDA device the process first makes its card the current
    one: the device's index, or :func:`local_card` where it names none, so
    that the processes of one host drive one card each (NCCL refuses two
    ranks on one card).  Without a coordinator it does nothing and returns
    False."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return False                      # a single-process run
    if num_processes is None:
        num_processes = os.environ["JAX_NUM_PROCESSES"]
    if process_id is None:
        process_id = os.environ["JAX_PROCESS_ID"]
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else local_card(int(process_id)))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def multihost_mesh(t: int = 1, axis_names=("dp", "t"), device=None,
                   t_procs: int = 1) -> pmesh.Mesh:
    """The (dp, t) mesh over the processes, on this process's device
    (None: its current CUDA card, the one :func:`init_distributed` chose).

    ``t`` is the size of "t".  With ``t_procs`` = 1, dp = the processes and
    each stacks all t shards on its device.  With ``t_procs`` > 1 every
    t_procs consecutive ranks (a host's cards, with processes numbered host
    by host) form a "t" group, each stacking t // t_procs shards, and dp =
    world // t_procs: "dp" joins the ranks at one position of every "t"
    group.  Every process creates every group, in the same order.  Raises
    ``ValueError`` where t_procs divides the world or t unevenly."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if t_procs < 1 or world % t_procs or t % t_procs:
        raise ValueError(f"t = {t} over a world of {world} processes does "
                         f"not split into t_procs = {t_procs}")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    dp = world // t_procs
    shape = dict(zip(axis_names, (dp, t)))
    if not dist.is_initialized():
        return pmesh.Mesh(tuple(axis_names), shape, device)
    if t_procs == 1:
        return pmesh.Mesh(tuple(axis_names), shape, device, dist.group.WORLD)
    t_groups = [dist.new_group([d * t_procs + j for j in range(t_procs)])
                for d in range(dp)]
    dp_groups = [dist.new_group([d * t_procs + j for d in range(dp)])
                 for j in range(t_procs)]
    rank = dist.get_rank()
    return pmesh.Mesh(tuple(axis_names), shape, device,
                      group=dp_groups[rank % t_procs],
                      t_group=t_groups[rank // t_procs],
                      t_rank=rank % t_procs, t_local=t // t_procs)


def gather_frames(mesh: pmesh.Mesh, *tensors: torch.Tensor):
    """Each process's rows of per-frame results, end to end in the order of
    the "dp" group: the global [B, ...] on every process (the tensors
    themselves on a mesh without a group).  The processes of a "t" group
    hold the same rows, so the rows cross the "dp" group alone.  Over gloo
    the rows cross as CPU copies and come back on the CPU; over NCCL on
    the device."""
    if mesh.group is None:
        return tensors
    world = dist.get_world_size(mesh.group)
    on_cpu = dist.get_backend(mesh.group) == "gloo"
    out = []
    for x in tensors:
        x = x.cpu() if on_cpu else x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=mesh.group)
        out.append(torch.cat(parts))
    return tuple(out)
