"""Meshes (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group and no device.

Single pod:  (16, 16) over ("data", "model") = 256 devices.
Multi-pod:   (2, 16, 16) over ("pod", "data", "model") = 512 devices; the
"pod" axis composes with "data" for batch/gradient parallelism (one
gradient all-reduce a step crosses pods), while "model" (TP/EP) stays
inside a pod on the fast links.

Two kinds of mesh:

- :class:`AbstractMesh`: axis names and sizes, no devices and no process
  group.  The sharding rules (``repro_torch.parallel``) and the dry run
  (``launch/dryrun.py``) need nothing more: torch has no counterpart of
  the reference's 512 placeholder host devices.
- :class:`Mesh`: the same over a live process group, built on
  ``torch.distributed.device_mesh.init_device_mesh``; rank r sits at the
  row-major coordinate of r (the reference's device order on its test
  meshes).  It holds the ``DeviceMesh`` (placements) and one process
  group for every set of axes a collective runs over.  A mesh on
  ``cuda`` needs an NCCL group of the mesh's size, a mesh on ``cpu`` a
  ``gloo`` group; without it the constructor raises, naming the size.  It
  never falls back to another backend or device.

``batch_axes`` says which axes the rank's batch rows are split over (the
train step sets it from ``batch_shardings``; serving keeps every row on
every rank, ``()``), so a model under a mesh knows which ranks hold the
same rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math

import torch


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, row-major (the first axis is the slowest)."""

    dims: tuple[int, ...]
    axis_names: tuple[str, ...]
    batch_axes: tuple[str, ...] | None = None

    def __post_init__(self):
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.dims} vs axes "
                             f"{self.axis_names}")
        if self.batch_axes is None:
            object.__setattr__(self, "batch_axes", self.dp_axes)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @property
    def dp_axes(self) -> tuple[str, ...]:
        """The data-parallel axes, ("pod", "data") where present."""
        return tuple(a for a in self.axis_names if a in ("pod", "data"))

    def axes_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def coords(self, rank: int) -> dict[str, int]:
        """The mesh coordinate of ``rank`` (row-major)."""
        out = {}
        for a, n in zip(reversed(self.axis_names), reversed(self.dims)):
            out[a] = rank % n
            rank //= n
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for a, n in zip(self.axis_names, self.dims):
            r = r * n + coords[a]
        return r

    def axes_index(self, coords: dict[str, int], axes) -> int:
        """The mixed-radix index of ``coords`` over ``axes`` (the first
        axis major), the position of a rank's piece of a dim sharded over
        ``axes``."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + coords[a]
        return i


class Mesh(AbstractMesh):
    """A mesh over the live process group (see the module docstring)."""

    def __init__(self, dims, axis_names, device: str = "cuda",
                 batch_axes=None, _groups=None, _device_mesh=None):
        super().__init__(tuple(dims), tuple(axis_names), batch_axes)
        dist = torch.distributed
        self.device_type = torch.device(device).type
        backend = {"cuda": "nccl", "cpu": "gloo"}.get(self.device_type)
        if backend is None:
            raise ValueError(f"a mesh runs on cuda or cpu, not {device!r}")
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"a {self.device_type} mesh of shape {self.dims} needs a "
                f"{backend} process group of {self.size} ranks; none is "
                "initialized (torch.distributed.init_process_group)")
        if dist.get_world_size() != self.size:
            raise RuntimeError(
                f"a mesh of shape {self.dims} needs a process group of "
                f"{self.size} ranks; this one has {dist.get_world_size()}")
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(
                f"a {self.device_type} mesh needs the {backend} backend of "
                f"{self.size} ranks; the process group is {have}")
        self.rank = dist.get_rank()
        if _device_mesh is None:
            from torch.distributed.device_mesh import init_device_mesh

            _device_mesh = init_device_mesh(self.device_type, self.dims,
                                            mesh_dim_names=self.axis_names)
        self.device_mesh = _device_mesh
        self._groups = _groups if _groups is not None else self._new_groups()

    def _new_groups(self) -> dict:
        """One group for every non-empty set of axes (in mesh order) that
        holds this rank, made on every rank in the same order."""
        dist = torch.distributed
        groups = {}
        names = self.axis_names
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                if len(axes) == 1:
                    groups[axes] = self.device_mesh.get_group(axes[0])
                    continue
                if axes == names:
                    groups[axes] = dist.group.WORLD
                    continue
                rest = [a for a in names if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    ranks = sorted(
                        self.rank_of({**dict(zip(rest, fixed)), **dict(
                            zip(axes, c))})
                        for c in itertools.product(
                            *(range(self.shape[a]) for a in axes)))
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        groups[axes] = g
        return groups

    def group(self, axes):
        """The process group over ``axes`` holding this rank."""
        axes = tuple(a for a in self.axis_names if a in axes)
        return self._groups[axes]

    @property
    def coord(self) -> dict[str, int]:
        return self.coords(self.rank)

    @property
    def device(self) -> torch.device:
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def with_batch_axes(self, axes) -> "Mesh":
        """The same mesh (the same groups) with ``batch_axes`` = ``axes``."""
        return Mesh(self.dims, self.axis_names, self.device_type,
                    tuple(axes), self._groups, self.device_mesh)

    def __repr__(self) -> str:
        return (f"Mesh({self.dims}, {self.axis_names}, "
                f"{self.device_type}, rank {self.rank})")


class TracingMesh(AbstractMesh):
    """An abstract mesh a program runs under on the ``meta`` device (the
    dry run's op count): the coordinate of rank ``rank``, and for a set of
    axes a ``parallel.comm.FakeGroup`` of that rank's group, whose
    collectives make outputs of the right shapes and are counted, not
    issued."""

    def __init__(self, dims, axis_names, rank: int = 0, batch_axes=None):
        super().__init__(tuple(dims), tuple(axis_names), batch_axes)
        self.rank = rank

    @property
    def coord(self) -> dict[str, int]:
        return self.coords(self.rank)

    @property
    def device(self) -> torch.device:
        return torch.device("meta")

    def group(self, axes):
        from repro_torch.parallel.comm import FakeGroup

        axes = tuple(a for a in self.axis_names if a in axes)
        c = self.coord
        ranks = tuple(sorted(
            self.rank_of({**c, **dict(zip(axes, idx))})
            for idx in itertools.product(*(range(self.shape[a])
                                           for a in axes))))
        return FakeGroup(axes, ranks)

    def with_batch_axes(self, axes) -> "TracingMesh":
        return TracingMesh(self.dims, self.axis_names, self.rank,
                           tuple(axes))


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda",
                         abstract: bool = False):
    """The (16, 16) or (2, 16, 16) production mesh: an :class:`AbstractMesh`
    with ``abstract`` (the dry run), else a :class:`Mesh`, which needs a
    process group of 256 or 512 ranks."""
    dims, axes = PRODUCTION[multi_pod]
    if abstract:
        return AbstractMesh(dims, axes)
    return Mesh(dims, axes, device)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device: str = "cuda"):
    """A small mesh over the live process group (the CPU tests: ``gloo``
    with ``device="cpu"``; the card: NCCL at world size 1)."""
    return Mesh(tuple(shape), tuple(axes), device)


@contextlib.contextmanager
def use_mesh(mesh):
    """Context manager entering ``mesh``: the reference's shim over
    ``jax.set_mesh``.  The port hands its mesh to every call that shards
    (``mesh=``), so entering one changes nothing."""
    yield mesh
