"""The job's ranks as a mesh, and the rules that give a rank its rows.

Counterpart of ``dotaclient_tpu/parallel/mesh.py``. Axes, as there:

* ``dcn``: the slices (hosts or islands) of a multi-slice job; present only
  when ``dcn_slices > 1``;
* ``data``: the batch axis; gradients are summed over it (and over ``dcn``);
* ``model``: the tensor-parallel axis, innermost, so its ranks are
  neighbours.

The reference's ``Mesh`` is an array of devices that one controller drives;
the port's is this rank's view of the same layout: the axis names and
sizes, this rank's coordinates, one process group an axis, the batch
group over the (dcn x) data axes and the group of every rank of the mesh
(``all_group``: the whole params of the tensor-parallel layout), each of
the last two with a gloo twin for host tensors when the job's backend is
NCCL (``all_host_group`` carries the learner's agreements and the host-fed
ring's door). The reference's ``NamedSharding`` rules
(``data_sharding``, ``replicated``, ``row_sharding``) become the rules that
give a rank its local row range of a leading axis.

Built with explicit ``world_size`` and ``rank`` the mesh is a layout alone,
with no groups, so its rules can be read with no processes.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from dotaclient_tpu_torch.config import MeshConfig
from dotaclient_tpu_torch.parallel.distributed import DEFAULT_TIMEOUT_S, is_initialized


@dataclasses.dataclass
class Mesh:
    """This rank's view of the job's ``(dcn?, data, model)`` layout. A
    rank past the mesh (an explicit layout smaller than the world) has no
    coordinates and no groups."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    world_size: int
    coords: Optional[Dict[str, int]]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    batch_group: Optional[dist.ProcessGroup] = None
    batch_host_group: Optional[dist.ProcessGroup] = None
    batch_axis_names: Tuple[str, ...] = ()
    all_group: Optional[dist.ProcessGroup] = None
    all_host_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Ranks in the mesh (the reference's ``mesh.devices.size``)."""
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def member(self) -> bool:
        return self.coords is not None

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The process group of ``axis`` (None for a size-1 axis or a
        layout without groups)."""
        return self.groups.get(axis)

    def ranks_of(self, fixed: Dict[str, int], free: Tuple[str, ...]) -> List[int]:
        """The global ranks that share ``fixed`` coordinates, ordered over
        the ``free`` axes (row-major in mesh order)."""
        out = []
        for combo in itertools.product(*(range(self.shape[a]) for a in free)):
            c = {**fixed, **dict(zip(free, combo))}
            r = 0
            for a, s in zip(self.axis_names, self.sizes):
                r = r * s + c[a]
            out.append(r)
        return out


def _coords(rank: int, names: Tuple[str, ...], sizes: Tuple[int, ...]) -> Dict[str, int]:
    out = {}
    for a, s in reversed(list(zip(names, sizes))):
        out[a] = rank % s
        rank //= s
    return {a: out[a] for a in names}


def make_mesh(config: MeshConfig, world_size: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """The ``(data, model)`` or ``(dcn, data, model)`` mesh over the job's
    ranks (default: the initialized process group's, else a world of 1).

    An explicit ``data_parallel`` whose layout is smaller than the world
    takes the first ``dcn x data x model`` ranks, as the reference takes
    the first devices. With ``world_size`` given, the mesh is a layout with
    no process groups. Otherwise every rank of the group must call this
    (it makes the groups collectively)."""
    with_groups = world_size is None and is_initialized()
    if world_size is None:
        world_size, rank = (dist.get_world_size(), dist.get_rank()) if with_groups else (1, 0)
    rank = 0 if rank is None else rank
    model = max(1, config.model_parallel)
    dcn = max(1, config.dcn_slices)
    data = config.data_parallel
    n = world_size
    if data > 0 and dcn * data * model < n:
        n = dcn * data * model
    if n % (model * dcn):
        raise ValueError(f"{n} devices not divisible by dcn_slices×model_parallel={dcn}x{model}")
    if data == -1:
        data = n // (model * dcn)
    if dcn * data * model != n:
        raise ValueError(f"mesh {dcn}x{data}x{model} != {n} devices")
    if dcn > 1:
        names, sizes = (config.dcn_axis, config.data_axis, config.model_axis), (dcn, data, model)
    else:
        names, sizes = (config.data_axis, config.model_axis), (data, model)
    mesh = Mesh(axis_names=names, sizes=sizes, rank=rank, world_size=world_size,
                coords=_coords(rank, names, sizes) if rank < n else None, groups={})
    mesh.batch_axis_names = batch_axes(mesh, config)
    if with_groups and n > 1:
        _make_groups(mesh, config)
    return mesh


def _make_groups(mesh: Mesh, config: MeshConfig) -> None:
    """One group an axis of size > 1, the batch group and the mesh's group,
    each made by every rank of the world in the same order (``new_group`` is collective), each
    timing out as the runtime's default does."""
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    gloo_twin = dist.get_backend() != "gloo"
    shape = mesh.shape

    def each_group(free: Tuple[str, ...], backend: Optional[str] = None):
        fixed_axes = tuple(a for a in mesh.axis_names if a not in free)
        mine = None
        for combo in itertools.product(*(range(shape[a]) for a in fixed_axes)):
            ranks = mesh.ranks_of(dict(zip(fixed_axes, combo)), free)
            g = dist.new_group(ranks, timeout=timeout, backend=backend)
            if mesh.rank in ranks:
                mine = g
        return mine

    for a in mesh.axis_names:
        if shape[a] > 1:
            mesh.groups[a] = each_group((a,))
    free = mesh.batch_axis_names
    if batch_shard_count(mesh, config) > 1:
        mesh.batch_group = each_group(free)
        mesh.batch_host_group = each_group(free, backend="gloo") if gloo_twin else mesh.batch_group
    mesh.all_group = each_group(mesh.axis_names)
    mesh.all_host_group = each_group(mesh.axis_names, backend="gloo") if gloo_twin else mesh.all_group


def axis_group(mesh: Mesh, axis: str) -> Tuple[Optional[dist.ProcessGroup], int, int]:
    """(the group, the size, this rank's coordinate) of ``axis``, for a
    primitive that runs over it; raises on a layout without groups."""
    n = mesh.shape[axis]
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside the mesh {mesh.shape}")
    group = mesh.group(axis)
    if n > 1 and group is None:
        raise ValueError("this mesh is a layout without process groups (built with world_size=): "
                         "build it in an initialized process group")
    return group, n, mesh.coords[axis]


def batch_axes(mesh: Mesh, config: MeshConfig) -> Tuple[str, ...]:
    """Mesh axes the batch dimension shards over: (dcn?, data)."""
    axes = []
    if config.dcn_axis in mesh.shape:
        axes.append(config.dcn_axis)
    axes.append(config.data_axis)
    return tuple(axes)


def batch_shard_count(mesh: Mesh, config: MeshConfig) -> int:
    """How many ways the batch dimension splits: the divisibility unit of
    batch sizes and ring capacity, shared by the learner and the ring."""
    n = 1
    for a in batch_axes(mesh, config):
        n *= mesh.shape[a]
    return n


def batch_index(mesh: Mesh, config: MeshConfig) -> int:
    """This rank's index among the batch shards (dcn-major)."""
    i = 0
    for a in batch_axes(mesh, config):
        i = i * mesh.shape[a] + mesh.coords[a]
    return i


def data_sharding(mesh: Mesh, config: MeshConfig, n_rows: int) -> slice:
    """This rank's rows of an ``n_rows`` leading axis sharded over the
    (dcn x) data axes; the rows must split evenly."""
    n = batch_shard_count(mesh, config)
    if n_rows % n:
        raise ValueError(f"{n_rows} rows not divisible by the batch shard count {n}")
    per = n_rows // n
    i = batch_index(mesh, config)
    return slice(i * per, (i + 1) * per)


def replicated(mesh: Mesh, n_rows: int) -> slice:
    """Every row: the leaf is whole on every rank."""
    return slice(0, n_rows)


def row_sharding(mesh: Mesh, config: MeshConfig, n_rows: int) -> slice:
    """Data-sharded when the rows split evenly over the batch shards,
    replicated otherwise: the one divisibility rule of the lane-sharded
    actor state (true scalars and degenerate layouts stay whole)."""
    n = batch_shard_count(mesh, config)
    if n_rows > 0 and n_rows % n == 0:
        return data_sharding(mesh, config, n_rows)
    return replicated(mesh, n_rows)


def collective_probe_ms(mesh: Mesh, config: MeshConfig, device: torch.device) -> float:
    """One blocking all-reduce round trip of one value per batch shard over
    the batch group, in milliseconds (the ``learner/psum_ms`` gauge). A
    startup probe: the train loop never blocks on its reductions, so their
    cost is not separable without a profiler. On a world of 1 it is a sum
    and a read of the device. Call it at construction, never in the loop."""
    x = torch.ones((1,), dtype=torch.float32, device=device)
    group = mesh.batch_group

    def once() -> float:
        y = x.clone()
        if group is not None:
            dist.all_reduce(y, group=group)
        return float(y.sum().item())   # host-sync-ok: a startup probe

    once()   # the first collective pays the communicator's set-up
    t0 = time.perf_counter()
    once()
    return (time.perf_counter() - t0) * 1e3
