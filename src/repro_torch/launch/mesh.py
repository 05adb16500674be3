"""Device meshes over torch.distributed ranks (port of ``repro.launch.mesh``).

A mesh names the axes of the ranks of the default process group: rank
``r`` sits at ``np.unravel_index(r, shape)``, row-major, as
``jax.make_mesh`` lays out its devices.  For every set of axes the mesh
holds a process group of the ranks that differ only in those axes
(``get_group``): the train step reduces gradients over ``("pod",
"data")`` and exchanges the compressed ones over ``"pod"``.

The ranks may share one card: the mesh's device is the caller's, never
picked by rank (NCCL refuses two ranks on one GPU, so such a world runs on
gloo, and ``distributed.collectives`` stages what gloo cannot gather on a
CUDA tensor through host memory).

``abstract_mesh`` needs no process group: the sharding rules and their
tests resolve against its axis names and sizes alone.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes (``.shape[name]``), no ranks."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]


def abstract_mesh(axis_sizes, axis_names) -> AbstractMesh:
    return AbstractMesh(tuple(axis_names),
                        dict(zip(axis_names, (int(s) for s in axis_sizes))))


class Mesh:
    """The ranks of the default process group as a named grid, with a
    process group for every set of axes and the device the caller's
    tensors live on."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: Union[str, torch.device]):
        sizes = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names, (
            int(c) for c in np.unravel_index(self.rank, sizes))))
        grid = np.arange(int(np.prod(sizes))).reshape(sizes)
        n_axes = len(sizes)
        self._groups = {}
        # every rank creates every group, in the same order (a collective)
        for n in range(1, n_axes + 1):
            for axes in itertools.combinations(range(n_axes), n):
                rest = [i for i in range(n_axes) if i not in axes]
                members = np.transpose(grid, rest + list(axes)).reshape(
                    -1, int(np.prod([sizes[i] for i in axes])))
                mine, _ = dist.new_subgroups_by_enumeration(
                    [[int(r) for r in row] for row in members])
                self._groups[tuple(self.axis_names[i] for i in axes)] = mine

    def _axes(self, names: Axes) -> Tuple[str, ...]:
        names = (names,) if isinstance(names, str) else tuple(names)
        unknown = [a for a in names if a not in self.axis_names]
        if unknown:
            raise KeyError(f"axes {unknown} not in the mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def get_group(self, names: Axes):
        """The process group of the ranks that differ from this one only in
        ``names``; its group ranks follow the coordinates along them."""
        return self._groups[self._axes(names)]

    def size(self, names: Axes) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(names)]))

    def index(self, names: Axes) -> int:
        """This rank's row-major position along ``names``."""
        axes = self._axes(names)
        if not axes:
            return 0
        return int(np.ravel_multi_index([self.coords[a] for a in axes],
                                        [self.shape[a] for a in axes]))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device="cuda") -> Mesh:
    """``shape`` over ``axis_names`` on the ranks of the initialized default
    process group, whose size must be ``prod(shape)``; tensors on
    ``device`` (the card by default)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs "
                         f"{int(np.prod(shape))} ranks, the world has {world}")
    return Mesh(shape, axis_names, device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16 x 16 = 256 ranks a pod; multi-pod adds a leading 2-pod axis (512).

    ``REPRO_MULTI_SHAPE=2,8,16`` overrides the multi-pod shape, as in the
    reference.  Raises unless the world has that many ranks.
    """
    if multi_pod:
        shape = tuple(int(x) for x in os.environ.get(
            "REPRO_MULTI_SHAPE", "2,16,16").split(","))
        return make_mesh(shape, ("pod", "data", "model"), device)
    return make_mesh((16, 16), ("data", "model"), device)


def make_host_mesh(device="cuda") -> Mesh:
    """The whole world as a 1-D data mesh, ``(n, 1)`` over ``("data",
    "model")``."""
    return make_mesh((dist.get_world_size(), 1), ("data", "model"), device)
