"""Device meshes over ``torch.distributed`` ranks.

Port of ``repro/launch/mesh.py``.  Axes:

    pod   — FL clients (FLTorrent dissemination axis; DP-outer)
    data  — within-client data parallel axis
    model — tensor / expert parallel axis

A ``DeviceMesh`` is a grid of global ranks with named axes, as
``jax.sharding.Mesh`` is a grid of devices: one rank a device (one GPU
a rank with NCCL, one CPU process a rank with gloo).  It carries this
rank's process group along each axis of size > 1, so code that runs
over an axis (the torrent ring over ``pod``, gradient averaging over
``data``, the expert-parallel MoE over ``model``) reads its group and
its index from the mesh.

``dist.new_group`` is collective over the whole default group: every
rank must create every group, in the same order, members or not.  So
each mesh builds the groups of all its lines along all its axes on
every rank, and the groups of one grid of ranks are built once per
process and cached: an elastic run that goes P -> P-1 -> P creates the
P-pod groups once.  A rank outside a (shrunken) mesh holds a mesh with
no coordinates and no groups.

Without an initialised process group the world is this one process
(rank 0, world size 1), so a mesh of size 1 builds and a larger one
raises ``ValueError``, as the JAX package does with too few devices.
Importing this module touches no process group.

A mesh also carries a ``torch.distributed`` device mesh over its axes
of size > 1 (``dtensor_mesh``, built from the same groups), which
DTensor placements need.  ``fake_world(n)`` is the dry run's world:
this process is rank 0 of n ranks on the ``fake`` backend, whose
collectives move nothing, as JAX's placeholder host devices stand in
for a pod.  The group cache is keyed by the world, and leaving a fake
world drops its groups, so a real run after a dry run in the same
process gets real groups.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.api import axis_sizes

# (world, shape, axis names, ranks) -> {(axis, line index): ProcessGroup}
_GROUPS: dict = {}
# the device type fake tensors claim in a fake world, or None
_FAKE_DEVICE: list = [None]


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(device="cuda", *, init_method: str = "env://",
                     rank: int | None = None,
                     world_size: int | None = None) -> torch.device:
    """Join the default process group and return this rank's device.

    Reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` from the
    environment ``torch.distributed.run`` gives each worker, unless
    ``rank`` and ``world_size`` are passed.  ``device`` ``"cuda"``
    selects ``cuda:LOCAL_RANK`` first and joins with NCCL; ``"cpu"``
    joins with gloo.  A failure to initialise is not caught.
    """
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    kind = torch.device(device).type
    if kind == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        dev, backend = torch.device("cuda", local), "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


def _world_key():
    """Identifies the default process group, so cached groups never
    outlive the world they were made in."""
    if dist.is_available() and dist.is_initialized():
        return (id(dist.group.WORLD), dist.get_world_size())
    return None


@contextlib.contextmanager
def fake_world(world_size: int, device="cpu"):
    """This process as rank 0 of ``world_size`` ranks on the ``fake``
    backend, for the duration of the block.

    Collectives run on every tensor kind (fake tensors among them) and
    move nothing.  ``device`` is the device type the dry run's fake
    tensors claim; meshes made inside build their DTensor meshes for
    it.  On exit the default group is destroyed and every cached group
    dropped.  Refuses to start inside another world.
    """
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; a "
                           "fake world needs a process of its own")
    # importing torch's testing helper registers the backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    store = FakeStore()
    _GROUPS.clear()               # groups of a world that has ended
    dist.init_process_group("fake", store=store, rank=0,
                            world_size=world_size)
    _FAKE_DEVICE[0] = torch.device(device).type
    try:
        yield
    finally:
        _FAKE_DEVICE[0] = None
        _GROUPS.clear()
        dist.destroy_process_group()


def _device_type() -> str:
    """The device type DTensors of this world live on."""
    if _FAKE_DEVICE[0] is not None:
        return _FAKE_DEVICE[0]
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


class DeviceMesh:
    """A grid of global ranks with named axes, and this rank's groups.

    ``axis_names`` and ``devices`` (an int array of ranks shaped like
    the grid) mirror ``jax.sharding.Mesh``; ``shape`` is {axis: size}.
    ``coords`` is this rank's index along each axis and ``groups`` /
    ``group_ranks`` its process group and the group's global ranks
    along each axis of size > 1, or all None when the rank is outside
    the mesh.
    """

    def __init__(self, shape, axis_names, ranks):
        shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes "
                             f"{self.axis_names}")
        self.devices = np.asarray(list(ranks), dtype=np.int64).reshape(
            shape)
        self.shape = dict(zip(self.axis_names, shape))
        self.rank = world()[0]
        self.coords = None
        self.groups = None
        self.group_ranks = None
        lines = _axis_groups(self.devices, self.axis_names)
        hit = np.argwhere(self.devices == self.rank)
        if len(hit):
            at = tuple(int(i) for i in hit[0])
            self.coords = dict(zip(self.axis_names, at))
            self.groups, self.group_ranks = {}, {}
            for ax, name in enumerate(self.axis_names):
                if shape[ax] > 1:
                    key = at[:ax] + at[ax + 1:]
                    self.groups[name] = lines[name, key]
                    line = np.moveaxis(self.devices, ax, -1)[key]
                    self.group_ranks[name] = [int(r) for r in line]

    @property
    def is_member(self) -> bool:
        return self.coords is not None

    @property
    def dtensor_mesh(self):
        """A ``torch.distributed`` device mesh over this mesh's axes of
        size > 1, with their names and this mesh's groups; None when
        every axis has size 1.  Built once, on first use; needs a
        member rank."""
        if "_tmesh" not in self.__dict__:
            self._tmesh = self._build_dtensor_mesh()
        return self._tmesh

    def _build_dtensor_mesh(self):
        from torch.distributed.device_mesh import DeviceMesh as TorchMesh
        axes = [i for i, n in enumerate(self.axis_names)
                if self.shape[n] > 1]
        if not axes:
            return None
        if not self.is_member:
            raise ValueError(f"rank {self.rank} is outside {self}")
        names = tuple(self.axis_names[i] for i in axes)
        drop = tuple(i for i in range(len(self.axis_names))
                     if i not in axes)
        ranks = self.devices.reshape(
            tuple(self.devices.shape[i] for i in axes)) if drop else \
            self.devices
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():     # the mesh's own rank tensors
            return TorchMesh.from_group(
                [self.groups[n] for n in names], _device_type(),
                mesh=torch.as_tensor(ranks, dtype=torch.int64),
                mesh_dim_names=names)

    def submesh(self, names):
        """The ``torch.distributed`` mesh of this rank's line over the
        named axes (those of size > 1), or None."""
        tm = self.dtensor_mesh
        keep = tuple(n for n in names if n in (tm.mesh_dim_names
                                                if tm else ()))
        if not keep:
            return None
        if keep == tuple(tm.mesh_dim_names):
            return tm
        return tm[keep]

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape}, ranks "
                f"{self.devices.reshape(-1).tolist()}, rank {self.rank})")


def _axis_groups(devices: np.ndarray, axis_names) -> dict:
    """The process group of every line along every axis of size > 1,
    created on every rank in one order and cached per grid."""
    key = (_world_key(), devices.shape, tuple(axis_names),
           tuple(devices.reshape(-1)))
    if key in _GROUPS:
        return _GROUPS[key]
    out = {}
    for ax, name in enumerate(axis_names):
        if devices.shape[ax] <= 1:
            continue
        moved = np.moveaxis(devices, ax, -1)
        for idx in itertools.product(*(range(s) for s in moved.shape[:-1])):
            out[name, idx] = dist.new_group(
                [int(r) for r in moved[idx]])
    _GROUPS[key] = out
    return out


def _mesh(shape, axes, ranks=None, *, what: str = "") -> DeviceMesh:
    need = math.prod(shape)
    have = list(range(world()[1])) if ranks is None else list(ranks)
    if len(have) < need:
        raise ValueError(f"{need} devices needed for {what or shape}; "
                         f"have {len(have)}")
    return DeviceMesh(shape, axes, have[:need])


def make_production_mesh(*, multi_pod: bool = False, n_pods: int = 2):
    shape = (n_pods, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(shape=(1, 1), axes=("data", "model")):
    """Mesh over the first ranks of this run (tests, one process)."""
    return _mesh(shape, axes)


def make_pod_mesh(n_pods: int, *, data: int = 1, model: int = 1,
                  devices=None):
    """("pod", "data", "model") mesh over the first ranks — the elastic
    re-mesh entry point (§III-E).

    Dropping from P to P-1 pods keeps the first ``(P-1)*data*model``
    ranks; the torrent ring then runs P-2 stages over the new pod
    groups.  ``devices`` overrides the list of ranks to draw from.
    """
    return _mesh((n_pods, data, model), ("pod", "data", "model"), devices,
                 what=f"pods={n_pods} x data={data} x model={model}")


def pod_axis_size(mesh) -> int:
    """The mesh's ``pod`` axis size; 1 without a mesh or a pod axis."""
    return 1 if mesh is None else int(axis_sizes(mesh).get("pod", 1))


__all__ = ["DeviceMesh", "fake_world", "init_distributed", "make_host_mesh",
           "make_pod_mesh", "make_production_mesh", "pod_axis_size",
           "world"]
