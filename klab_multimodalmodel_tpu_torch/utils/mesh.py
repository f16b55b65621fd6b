"""Process group, rank device and mesh of distributed training.

The reference trains with ``torchrun --nproc_per_node=W train.py``: it calls
``dist.init_process_group("nccl")`` and wraps its model in
``DistributedDataParallel``. The JAX package replaced that with a device
mesh over the axes ``(data, fsdp, tensor, seq, pipe, expert)``; the port
goes back to the process group, one process per rank, and lays the ranks
out over all six axes in the JAX order, row-major (rank = ((((d F + f) T +
t) S + s) P + p) E + e). ``data`` alone: gradients all-reduced by DDP
(``train/trainer.py``). ``fsdp`` and ``tensor``: FSDP2 over ``(data,
fsdp)`` and DTensor tensor parallelism over ``tensor``
(``parallel/partitioning.py``), on a ``DeviceMesh`` of those three axes.
``seq``: each rank of a seq group runs its ``L / S`` positions of every T5
stack, the parameters replicated over it as over ``data``: alone beside
``data`` under DDP, whose gradient all-reduce then spans data x seq;
beside ``fsdp`` or ``tensor`` under FSDP2 over ``(data, fsdp)``, with the
reduced shards then summed over the seq group (``seq_group`` carries that
sum, the stacks' K/V exchange and the MoE routing's counts;
``loss_groups`` the token counts and losses over data x fsdp x seq).
``pipe``: pipe rank p holds stage p of the transformer's GPipe schedule
(``pipe_group`` carries the stage shift); ``expert``: expert rank e holds
experts ``[e E/n, (e+1) E/n)`` of every MoE layer. The ranks of one tensor,
seq, pipe or expert group share their rows: the batch splits over the
``data x fsdp`` index (``dp_rank`` of ``dp_size``). Under MoE a rank runs
its experts' ``d_ff / tensor`` columns: the tensor group sums their
outputs, the expert group the combine, and the ``moe_group`` (tensor x
expert at the rank's seq coordinate) the tokens' gradient
(``ops/moe.py``). One ``DeviceMesh`` spans all six axes in the same rank
order; FSDP2's ``(data, fsdp)`` sub-mesh, the ``tensor`` sub-mesh and the
groups of the other axes come from it.
Under ``pipe`` with ``fsdp`` or ``tensor`` a stage's blocks are FSDP2 units
of its ``(data, fsdp)`` peers and tensor-parallel over its tensor peers; a
pipe group joins the ranks of one data, fsdp and tensor coordinate.
``pipe`` above 1 beside ``seq`` or ``expert`` above 1 raises, as the JAX
``Config`` refuses GPipe stages with a seq axis and MoE with stages
(``refuse_pipe_beside``).

Rendezvous comes from the environment, as torchrun sets it (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or from
the JAX package's variables (``KLAB_MULTIHOST=1`` with ``KLAB_COORDINATOR``
host:port, ``KLAB_NUM_PROCESSES`` and ``KLAB_PROCESS_ID``). A world of one
process initializes nothing. The backend is NCCL on the card and gloo on
the CPU; gloo on CUDA tensors (two ranks sharing one card, which NCCL
refuses) only when ``KLAB_CPU_COLLECTIVES=gloo`` asks for it. Each rank runs on ``cuda:LOCAL_RANK``; a rank
whose card does not exist raises unless its device is given explicitly.
Host-side agreement (halts, bucket widths, barriers) goes over a gloo group
of CPU tensors, so that it never waits on the card.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
from datetime import timedelta
from typing import Mapping, Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..config import STAGES_WITH_MOE, STAGES_WITH_SEQ
from .device import resolve_device

DEFAULT_AXIS_NAMES = ("data", "fsdp", "tensor", "seq", "pipe", "expert")
# Generous: the first collective waits for the slowest rank's model build
# and, on a cold tree, the kernels' build.
TIMEOUT = timedelta(minutes=30)


def pad_mesh_shape(mesh_shape: Sequence[int],
                   n_axes: int = len(DEFAULT_AXIS_NAMES),
                   fill: int = 1) -> tuple[int, ...]:
    """Right-pad a mesh shape with 1s to the axis-name count (3-tuple
    ``(data, fsdp, tensor)`` shapes address the 6-axis mesh unchanged)."""
    shape = tuple(int(s) for s in mesh_shape)
    if len(shape) > n_axes:
        raise ValueError(f"mesh_shape {shape} has more than {n_axes} axes")
    return shape + (fill,) * (n_axes - len(shape))


def resolve_mesh_shape(mesh_shape: Sequence[int],
                       num_devices: int) -> tuple[int, ...]:
    """Resolve a -1 entry ("all remaining devices") in the mesh shape."""
    shape = list(mesh_shape)
    fixed = math.prod(s for s in shape if s != -1)
    n_wild = sum(1 for s in shape if s == -1)
    if n_wild > 1:
        raise ValueError(f"at most one -1 in mesh_shape, got {mesh_shape}")
    if n_wild == 1:
        if num_devices % fixed != 0:
            raise ValueError(
                f"mesh_shape {mesh_shape} does not divide {num_devices} devices")
        shape[shape.index(-1)] = num_devices // fixed
    if math.prod(shape) != num_devices:
        raise ValueError(
            f"mesh_shape {shape} != device count {num_devices}")
    return tuple(shape)


# A pipe axis needs as many GPipe stages; an expert axis needs MoE.
PIPE_BESIDE = {"seq": STAGES_WITH_SEQ, "expert": STAGES_WITH_MOE}


def refuse_pipe_beside(shape: Sequence[int],
                       axis_names: Sequence[str] = DEFAULT_AXIS_NAMES
                       ) -> None:
    """Raise the JAX ``Config``'s ``ValueError`` for ``pipe`` above 1
    beside ``seq`` or ``expert`` above 1 (a -1 counts as above 1): the
    stages that a pipe axis needs take neither."""
    size = {n: int(v) for n, v in zip(axis_names, shape)}
    if size.get("pipe", 1) == 1:
        return
    for axis in ("seq", "expert"):
        if size.get(axis, 1) != 1:
            raise ValueError(PIPE_BESIDE[axis])


def axis_groups(shape: Sequence[int], axes: Sequence[int]
                ) -> list[list[int]]:
    """The groups of a row-major rank layout of ``shape`` along ``axes``
    (indices into ``shape``): the ranks of a group share every other
    axis's coordinate; groups in order of their first rank, members in
    rank order."""
    shape = [int(s) for s in shape]
    groups: dict[tuple, list[int]] = {}
    for r in range(math.prod(shape)):
        coords, rest = [], r
        for size in reversed(shape):
            coords.append(rest % size)
            rest //= size
        coords.reverse()
        key = tuple(c for i, c in enumerate(coords) if i not in axes)
        groups.setdefault(key, []).append(r)
    return list(groups.values())


@dataclasses.dataclass(frozen=True)
class DistEnv:
    """A process's place in the job: rank, world size, its card's index on
    its host, and the rendezvous (``env://`` under torchrun, whose agent
    holds the store, or ``tcp://host:port``)."""

    rank: int
    world_size: int
    local_rank: int
    init_method: str


def distributed_env(environ: Optional[Mapping[str, str]] = None
                    ) -> Optional[DistEnv]:
    """The job from torchrun's variables or the JAX package's ``KLAB_*``
    ones (torchrun's first); None when neither names one."""
    env = os.environ if environ is None else environ
    if "WORLD_SIZE" in env and "RANK" in env:
        for key in ("MASTER_ADDR", "MASTER_PORT"):
            if key not in env:
                raise ValueError(f"RANK and WORLD_SIZE are set but {key} "
                                 "is not: launch with torchrun")
        return DistEnv(rank=int(env["RANK"]),
                       world_size=int(env["WORLD_SIZE"]),
                       local_rank=int(env.get("LOCAL_RANK", 0)),
                       init_method="env://")
    if env.get("KLAB_MULTIHOST", "0") == "1":
        missing = [k for k in ("KLAB_COORDINATOR", "KLAB_NUM_PROCESSES",
                               "KLAB_PROCESS_ID") if not env.get(k)]
        if missing:
            raise ValueError(f"KLAB_MULTIHOST=1 needs {', '.join(missing)}"
                             " (no cluster is detected automatically)")
        rank = int(env["KLAB_PROCESS_ID"])
        return DistEnv(rank=rank, world_size=int(env["KLAB_NUM_PROCESSES"]),
                       local_rank=int(env.get("LOCAL_RANK", rank)),
                       init_method=f"tcp://{env['KLAB_COORDINATOR']}")
    return None


def rank_device(device: Optional[Union[str, torch.device]] = None,
                environ: Optional[Mapping[str, str]] = None
                ) -> torch.device:
    """The device of this process. Given: that device. Else, in a job of
    more than one process, ``cuda:LOCAL_RANK``, which must exist; else the
    card (``resolve_device``)."""
    if device is not None:
        return resolve_device(device)
    job = distributed_env(environ)
    if job is None or job.world_size == 1:
        return resolve_device(None)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if job.local_rank >= count:
        raise RuntimeError(
            f"rank {job.rank}: LOCAL_RANK {job.local_rank} has no card "
            f"({count} visible); pass the device explicitly (device='cpu', "
            "or one card that ranks share)")
    return resolve_device(torch.device("cuda", job.local_rank))


def maybe_init_distributed(device: Optional[Union[str, torch.device]] = None,
                           environ: Optional[Mapping[str, str]] = None
                           ) -> bool:
    """Join the job's process group (the reference's
    ``dist.init_process_group``). No-op when a group exists already (the
    caller's) or the job is one process; True when this call made it.
    ``device``: this rank's device (``rank_device``'s default otherwise).
    The backend: NCCL on the card, gloo on the CPU, and gloo on the card
    only when ``KLAB_CPU_COLLECTIVES=gloo`` asks for it."""
    if dist.is_initialized():
        return False
    env = os.environ if environ is None else environ
    job = distributed_env(env)
    if job is None or job.world_size == 1:
        return False
    dev = rank_device(device, env)
    asked = env.get("KLAB_CPU_COLLECTIVES", "")
    if asked not in ("", "gloo"):
        raise ValueError(f"KLAB_CPU_COLLECTIVES={asked!r}: the port's only "
                         "host backend is 'gloo'")
    backend = "gloo" if dev.type == "cpu" or asked else "nccl"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    print(f"rank {job.rank}/{job.world_size}: process group {backend} on "
          f"{dev}", file=sys.stderr, flush=True)
    dist.init_process_group(backend, init_method=job.init_method,
                            world_size=job.world_size, rank=job.rank,
                            timeout=TIMEOUT)
    return True


@dataclasses.dataclass
class Mesh:
    """The resolved ``(data, fsdp, tensor, seq, pipe, expert)`` shape and
    the groups that carry it: ``group`` (the world's, for gradients and
    device tensors; None in a process of its own) and ``cpu_group`` (gloo,
    for host values). ``rank`` is the world rank."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    group: Optional[dist.ProcessGroup]
    cpu_group: Optional[dist.ProcessGroup]
    rank: int = 0

    def size(self, name: str) -> int:
        """An axis's size (1 for an axis the names lack)."""
        if name not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(name)]

    @property
    def data(self) -> int:
        return self.size("data")

    @property
    def fsdp(self) -> int:
        return self.size("fsdp")

    @property
    def tensor(self) -> int:
        return self.size("tensor")

    @property
    def seq(self) -> int:
        return self.size("seq")

    @property
    def pipe(self) -> int:
        return self.size("pipe")

    @property
    def expert(self) -> int:
        return self.size("expert")

    @property
    def sharded(self) -> bool:
        """Whether parameters are sharded (``fsdp`` or ``tensor`` above
        1): FSDP2 and tensor parallelism instead of DDP."""
        return self.fsdp > 1 or self.tensor > 1

    @property
    def split(self) -> bool:
        """Whether the transformer's stages (``pipe``) or experts
        (``expert``) are split over ranks."""
        return self.pipe > 1 or self.expert > 1

    @property
    def dp_size(self) -> int:
        """The ranks that hold different rows: data x fsdp."""
        return self.data * self.fsdp

    @property
    def rows_share(self) -> int:
        """The ranks that share one data rank's rows: tensor x seq x pipe x
        expert, consecutive in rank order."""
        return self.tensor * self.seq * self.pipe * self.expert

    @property
    def dp_rank(self) -> int:
        """This rank's index over data x fsdp: the chunk of each global
        batch it draws, and the stream its dropout draws from (the ranks
        of one tensor x seq x pipe x expert block share both)."""
        return self.rank // self.rows_share

    @property
    def tensor_rank(self) -> int:
        """This rank's place in its tensor group."""
        return self.rank // (self.seq * self.pipe * self.expert) % self.tensor

    @property
    def seq_rank(self) -> int:
        """This rank's place in its seq group: it runs positions
        ``seq_rank * L / seq ..`` of every stack whose length L divides."""
        return self.rank // (self.pipe * self.expert) % self.seq

    @property
    def pipe_rank(self) -> int:
        """This rank's place in its pipe group: the stage it holds."""
        return self.rank // self.expert % self.pipe

    @property
    def expert_rank(self) -> int:
        """This rank's place in its expert group: it holds experts
        ``expert_rank * E / expert ..``."""
        return self.rank % self.expert

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def layout(self) -> torch.Tensor:
        """The world ranks laid out over the axes, row-major (``expert``
        fastest): the ``DeviceMesh``'s tensor, whose groups along each axis
        are ``axis_groups``'."""
        return torch.arange(math.prod(self.shape)).reshape(self.shape)

    def device_mesh(self, device_type: str):
        """The ``DeviceMesh`` over all six axes (``layout``) with named
        dims, made once per device type (a collective: every rank calls
        it). Its sub-meshes carry FSDP2 (``["data", "fsdp"]``), tensor
        parallelism (``["tensor"]``) and the other axes' groups."""
        return self._meshes(device_type)[0]

    def _meshes(self, device_type: str) -> tuple:
        """(the ``DeviceMesh``, its data x fsdp dims flattened into one: the
        rows' group, for token counts and losses; its tensor x seq x pipe x
        expert dims flattened: the ranks that share those rows), made once
        per device type, in one order on every rank."""
        meshes = self.__dict__.setdefault("_device_meshes", {})
        if device_type not in meshes:
            from torch.distributed.device_mesh import DeviceMesh

            mesh = DeviceMesh(device_type, self.layout(),
                              mesh_dim_names=self.axis_names)
            share = ("tensor", "seq", "pipe", "expert")
            meshes[device_type] = (
                mesh, mesh["data", "fsdp"]._flatten("dp"),
                mesh[share]._flatten("rows"))
        return meshes[device_type]

    def dp_group(self, device_type: str) -> Optional[dist.ProcessGroup]:
        """The group of this rank's copies of the other rows: the data x
        fsdp peers of its tensor, seq, pipe and expert coordinates (FSDP2's,
        and the balance loss's); the world's when the world is the data
        axis alone."""
        if self.sharded or self.split or self.seq > 1:
            return self._meshes(device_type)[1].get_group()
        return self.group

    def ddp_group(self, device_type: str) -> Optional[dist.ProcessGroup]:
        """The group of DDP's gradient all-reduce (nothing sharded): the
        ranks that hold the same parameters, data x seq; under the pipe or
        expert split those of this rank's stage or experts."""
        if not self.split:
            return self.group
        return self._axes_group(device_type, ("data", "seq"))

    def loss_groups(self, device_type: str) -> list:
        """The groups over which token counts and losses are summed, one
        after the other: together they span the ranks that hold other
        rows or other positions of them, data x fsdp x seq (each seq rank
        counts the target tokens of its own positions): the world's under
        DDP alone, else ``dp_group`` and, with ``seq``, the seq group."""
        if not (self.sharded or self.split):
            return [self.group]
        groups = [self.dp_group(device_type)]
        if self.seq > 1:
            groups.append(self.seq_group(device_type))
        return groups

    def _axes_group(self, device_type: str, axes: tuple
                    ) -> dist.ProcessGroup:
        """This rank's group along ``axes`` (``axis_groups``: the ranks
        that share every other axis's coordinate), made once per device
        type: every group of the layout, in one order on every rank."""
        made = self.__dict__.setdefault("_axes_groups", {})
        key = (device_type, axes)
        if key not in made:
            dims = [self.axis_names.index(a) for a in axes]
            made[key], _ = dist.new_subgroups_by_enumeration(
                axis_groups(self.shape, dims))
        return made[key]

    def tensor_group(self, device_type: str) -> dist.ProcessGroup:
        return self.device_mesh(device_type)["tensor"].get_group()

    def rows_group(self, device_type: str) -> Optional[dist.ProcessGroup]:
        """The group of the ranks that share this rank's rows (tensor x seq
        x pipe x expert), in rank order. None in a process of its own."""
        if not self.distributed:
            return None
        return self._meshes(device_type)[2].get_group()

    def moe_group(self, device_type: str) -> Optional[dist.ProcessGroup]:
        """The group of the ranks that split an MoE layer's banks at this
        rank's positions (tensor x expert, at its data, fsdp, seq and pipe
        coordinates), in rank order: it sums the tokens' gradient of the
        experts' partial outputs. None in a process of its own."""
        if not self.distributed:
            return None
        return self._axes_group(device_type, ("tensor", "expert"))

    def seq_group(self, device_type: str) -> Optional[dist.ProcessGroup]:
        """The group of this rank's seq peers (the ranks that share its
        rows and split their positions), in seq order; None when ``seq`` is
        1."""
        if self.seq == 1:
            return None
        return self.device_mesh(device_type)["seq"].get_group()

    def pipe_group(self, device_type: str) -> Optional[dist.ProcessGroup]:
        """The group of this rank's pipe peers (the other stages of its
        rows), in stage order; None when ``pipe`` is 1."""
        if self.pipe == 1:
            return None
        return self.device_mesh(device_type)["pipe"].get_group()

    def expert_group(self, device_type: str) -> Optional[dist.ProcessGroup]:
        """The group of this rank's expert peers (the other experts of its
        rows and d_ff columns), in expert order; None when ``expert`` is
        1."""
        if self.expert == 1:
            return None
        return self.device_mesh(device_type)["expert"].get_group()


# (world group, its gloo twin): held, so that a later group made after a
# destroy never meets a twin of an earlier one.
_CPU_GROUPS: list = []


def _cpu_group(group: dist.ProcessGroup) -> dist.ProcessGroup:
    """A gloo group over the same ranks as ``group``: the group itself when
    it is gloo, else one made once per process group."""
    if dist.get_backend(group) == "gloo":
        return group
    for g, cpu in _CPU_GROUPS:
        if g is group:
            return cpu
    cpu = dist.new_group(backend="gloo", timeout=TIMEOUT)
    _CPU_GROUPS.append((group, cpu))
    return cpu


def make_mesh(mesh_shape: Sequence[int] = (-1, 1, 1, 1, 1, 1),
              axis_names: Sequence[str] = DEFAULT_AXIS_NAMES,
              dcn_mesh_shape: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh over the world's processes (one, when no process group
    exists). Each axis is ``mesh_shape``'s entry (-1: the rest of the
    world) times ``dcn_mesh_shape``'s: the JAX package's parallelism across
    slices is, here, more ranks on that axis. ``pipe`` beside ``seq`` or
    ``expert`` raises the JAX ``Config``'s ValueError
    (``refuse_pipe_beside``)."""
    axis_names = tuple(axis_names)
    if set(axis_names) < set(DEFAULT_AXIS_NAMES):
        axis_names = axis_names + tuple(
            a for a in DEFAULT_AXIS_NAMES if a not in axis_names)
    n = len(axis_names)
    ici = pad_mesh_shape(mesh_shape, n)
    dcn = pad_mesh_shape(dcn_mesh_shape or (), n)
    refuse_pipe_beside([a * b for a, b in zip(ici, dcn)], axis_names)
    group = dist.group.WORLD if dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    n_slices = math.prod(dcn)
    if world % n_slices:
        raise ValueError(f"dcn_mesh_shape {dcn} needs a world size "
                         f"divisible by {n_slices}, got {world}")
    per_slice = resolve_mesh_shape(ici, world // n_slices)
    shape = tuple(a * b for a, b in zip(per_slice, dcn))
    return Mesh(shape=shape, axis_names=axis_names, group=group,
                cpu_group=_cpu_group(group) if group is not None else None,
                rank=dist.get_rank() if group is not None else 0)


def host_all_reduce(mesh: Mesh, values: Sequence[int],
                    op: str = "max") -> list[int]:
    """``values`` reduced elementwise over the mesh's processes ('max',
    'min' or 'sum') on the host's gloo group; themselves in a process of
    its own."""
    if not mesh.distributed:
        return [int(v) for v in values]
    ops = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
           "sum": dist.ReduceOp.SUM}
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    dist.all_reduce(t, op=ops[op], group=mesh.cpu_group)
    return t.tolist()


def barrier(mesh: Mesh) -> None:
    """Every process of the mesh waits for the others (on the host)."""
    if mesh.distributed:
        dist.monitored_barrier(group=mesh.cpu_group, timeout=TIMEOUT)
