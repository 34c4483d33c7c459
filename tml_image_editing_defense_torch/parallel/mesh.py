"""Ranks as a mesh (port of ``parallel/mesh.py``).

The JAX package drives a ``jax.sharding.Mesh`` of devices from one
controller, with a ``data`` axis for images and a ``reps`` axis for EOT
gradient samples (:20-22).  The port runs one process per GPU under
``torch.distributed``: every rank runs the same entry point, and a
:class:`Mesh` says where this rank sits on each axis and which process
group joins it to the ranks beside it on that axis.

- :func:`init_distributed` starts the process group from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``) and puts the rank on its card, so that ``"cuda"``
  is that card for the rest of the process.
- :func:`make_mesh` lays the axes over the ranks row-major, as the JAX
  mesh over devices.  A mesh smaller than the world tiles it: each block of
  ``prod(sizes)`` consecutive ranks is one copy of the mesh, and the copies
  repeat the same work.  Without a process group the world is one rank.
- :func:`all_reduce_`, :func:`broadcast_` and :func:`gather_blocks` are the
  collectives the sharded steps use; without a process group a mesh has no
  groups and they do nothing.
- :class:`AnyRankFlag` makes a stop flag that any rank may set stop every
  rank at the same iteration.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: The axis names of the JAX package: images over ranks, EOT reps over ranks.
DATA_AXIS = "data"
REPS_AXIS = "reps"

#: Process groups already made, by their ranks: a group is made once per
#: process and reused by every mesh over the same ranks.
_GROUPS: Dict[Tuple[int, ...], dist.ProcessGroup] = {}


def init_distributed(backend: Optional[str] = None, device="cuda",
                     init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> torch.device:
    """Start the default process group for this rank and return its device.

    The rank and world size come from torchrun's ``RANK`` and
    ``WORLD_SIZE`` unless given; ``init_method`` defaults to ``env://``
    (torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``).  ``backend`` defaults to
    ``"cpu:gloo,cuda:nccl"`` on ``device="cuda"``: NCCL for every tensor on
    the cards, gloo for the host-side flags of :class:`AnyRankFlag`; a
    failed NCCL start raises.  On the CPU it defaults to ``gloo``.  On CUDA
    the rank takes card ``LOCAL_RANK`` (modulo the cards present: ranks may
    share a card under gloo, which NCCL refuses).
    """
    device = torch.device(device)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for a gloo world on "
                               "the CPU")
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return device


def init_if_launched(device="cuda") -> bool:
    """Start the process group from the environment when the process was
    launched as one of several ranks (``WORLD_SIZE`` above 1, as torchrun
    sets it) and none is running yet; True when one runs afterwards."""
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_distributed(device=device)
    return dist.is_initialized()


def destroy_distributed() -> None:
    """End the default process group and forget the groups made over it."""
    _GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> Tuple[int, int]:
    """(this rank, the number of ranks); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_world_size() -> int:
    """The ranks on this rank's machine: torchrun's ``LOCAL_WORLD_SIZE``,
    else every rank (1 without a process group).  The entry points size
    their meshes from it, as the JAX package sizes its meshes from
    ``jax.local_devices()``, so that no tensor crosses machines."""
    rank, size = world()
    return int(os.environ.get("LOCAL_WORLD_SIZE", size)) if size > 1 else 1


def is_writer() -> bool:
    """Whether this rank writes the artifacts of its machine: the first
    rank of each machine (the only one without a process group)."""
    rank, _ = world()
    return rank % local_world_size() == 0


def machine_barrier() -> None:
    """Wait until every rank of this machine gets here (nothing without a
    process group): what the writing rank wrote is then there for all."""
    rank, size = world()
    if size > 1:
        per = local_world_size()
        first = rank - rank % per
        dist.barrier(group=_group(range(first, first + per)))


def _group(ranks: Sequence[int]) -> dist.ProcessGroup:
    """The process group of ``ranks`` (this rank among them), made on
    first use by its members only, so that ranks that make different meshes
    (machines with different work) never wait on each other here."""
    key = tuple(ranks)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key), use_local_synchronization=True)
    return _GROUPS[key]


@dataclass(frozen=True)
class Mesh:
    """This rank's place on a mesh of ranks: each axis's size, this rank's
    index on it, and the process group of the ranks that differ from this
    one on that axis only (None without a process group).  ``control`` is
    the group of this copy's ranks, for host-side flags (None for a mesh of
    one rank)."""

    shape: Dict[str, int]
    index: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]] = field(repr=False)
    ranks: Tuple[int, ...] = ()
    control: Optional[dist.ProcessGroup] = field(default=None, repr=False)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups.get(axis)

    def block(self, axis: str, n: int) -> range:
        """This rank's block of ``n`` items split evenly along ``axis``
        (JAX ``PartitionSpec(axis)``: contiguous blocks in axis order)."""
        size = self.size(axis)
        if n % size:
            raise ValueError(f"{n} items do not split over the {axis!r} axis of size {size}")
        per = n // size
        start = self.index.get(axis, 0) * per
        return range(start, start + per)


def make_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """The mesh ``axes`` (axis name -> size; default one ``data`` axis over
    every rank) laid over the ranks row-major, as the JAX ``make_mesh``
    (:25-50): in a copy of the mesh, rank ``r`` sits at the indices of
    ``r mod prod(sizes)`` in C order, so the last axis's ranks are
    consecutive.  One size may be -1, inferred.  The sizes must multiply to
    a divisor of the world size (``ValueError`` otherwise, as in JAX);
    without a process group the world is one rank."""
    rank, n = world()
    if axes is None:
        axes = {DATA_AXIS: n}
    names = tuple(axes)
    sizes = [int(s) for s in axes.values()]
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh axes {axes}: at most one size may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // known if known and n % known == 0 else 0
    total = math.prod(sizes)
    if total < 1 or total > n or n % total:
        raise ValueError(f"mesh axes {dict(zip(names, sizes))} incompatible with {n} ranks")
    base, local = rank - rank % total, rank % total
    coords, rest = [], local
    for s in reversed(sizes):
        coords.append(rest % s)
        rest //= s
    coords.reverse()
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    groups, copy_ranks = {}, tuple(range(base, base + total))
    for i, name in enumerate(names):
        groups[name] = None
        if dist.is_initialized():
            line_start = base + local - coords[i] * strides[i]
            groups[name] = _group([line_start + k * strides[i] for k in range(sizes[i])])
    control = _group(copy_ranks) if dist.is_initialized() and total > 1 else None
    return Mesh(dict(zip(names, sizes)), dict(zip(names, coords)), groups, copy_ranks, control)


def shard_along(mesh: Mesh, tensor: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``tensor`` along ``dim``, split over ``axis``
    (JAX ``shard_along`` places each device's block)."""
    rows = mesh.block(axis, tensor.shape[dim])
    return tensor.narrow(dim, rows.start, len(rows))


def replicate(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """Every rank holds the whole tensor (JAX ``replicate``)."""
    return tensor


def all_reduce_(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup],
                op=dist.ReduceOp.SUM) -> None:
    """Reduce each tensor in place over ``group`` (nothing without one).
    gloo and NCCL both take CUDA tensors for this collective."""
    if group is None:
        return
    for t in tensors:
        dist.all_reduce(t, op=op, group=group)


def broadcast_(tensors: Sequence[torch.Tensor], src: int,
               group: Optional[dist.ProcessGroup]) -> None:
    """Overwrite each tensor in place with the one of the group's rank
    ``src`` (an index in the group; nothing without a group).  gloo and
    NCCL both take CUDA tensors for this collective."""
    if group is None:
        return
    src = dist.get_global_rank(group, src % dist.get_world_size(group))
    for t in tensors:
        dist.broadcast(t, src=src, group=group)


def gather_blocks(mesh: Mesh, local: torch.Tensor, axis: str) -> torch.Tensor:
    """Every rank's block along ``axis`` (dim 0, in axis order) as one
    tensor on every rank: each rank writes its block into zeros and the sum
    over the axis group gathers them (x + 0 is x exactly), with the one
    collective both backends take on CUDA tensors."""
    group, size = mesh.group(axis), mesh.size(axis)
    if group is None:
        return local
    n = local.shape[0]
    full = local.new_zeros((size * n, *local.shape[1:]))
    i = mesh.index[axis]
    full[i * n:(i + 1) * n] = local
    all_reduce_([full], group)
    return full


class AnyRankFlag:
    """A stop flag for one copy of a mesh: true on every rank once
    ``flag`` is true on any.  Each ``bool()`` is one all-reduce (MAX) over
    ``mesh.control``, so every rank must poll it as often as the others
    (``run_pgd`` polls once an iteration, on every rank).  The flag travels
    on the host where the group has gloo; a group of NCCL alone takes it on
    the card, which waits for the card at every poll."""

    def __init__(self, flag, mesh: Mesh):
        self.flag, self.group = flag, mesh.control

    def __bool__(self) -> bool:
        if self.group is None:
            return bool(self.flag)
        on_host = "gloo" in str(dist.get_backend(self.group))
        t = torch.tensor([int(bool(self.flag))], dtype=torch.int32,
                         device="cpu" if on_host else "cuda")
        all_reduce_([t], self.group, op=dist.ReduceOp.MAX)
        return bool(t.item())
