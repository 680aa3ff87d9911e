"""Device meshes over a ``torch.distributed`` world (counterpart of
``repro/launch/mesh.py``).

A :class:`Mesh` names the axes of the world's ranks, laid out row-major
with the last axis fastest (as ``jax.make_mesh`` lays out devices), and
holds one process group for every subset of its axes: the ranks that
share this rank's coordinates on the other axes.  ``new_group`` is
collective over the whole world, so every group of every subset is
created at construction, in the same order on every rank; a group made
later on one rank only would hang the run.  A group's ranks are in
global-rank order, which for a subset of axes is major-to-minor in the
mesh's axis order.

:class:`AbstractMesh` has the sizes and names and no groups: the
sharding rules need nothing else (as ``jax.sharding.AbstractMesh`` in
the reference's rule tests).

    make_mesh((2, 2), ("data", "model"))     # needs a world of 4
    make_production_mesh(multi_pod=True)     # 2 x 16 x 16, a world of 512
    abstract_production_mesh()               # 16 x 16, no world
"""

from __future__ import annotations

import itertools
import math

import torch.distributed as dist


class AbstractMesh:
    """Axis names and sizes, no process groups: what the sharding rules
    read, and the planner's stand-in for a world (``launch/dryrun.py``).
    ``rank`` (default 0) picks the coordinates :meth:`index` reads; the
    rank arithmetic is :class:`Mesh`'s, which adds the groups."""

    def __init__(self, sizes, names, rank: int = 0):
        sizes, names = tuple(int(s) for s in sizes), tuple(names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh sizes {sizes} and names {names} do not pair up")
        self.axis_names = names
        self.shape = dict(zip(names, sizes))      # ordered name -> size
        self.size = math.prod(sizes)
        self.rank = rank
        self.coords = self.coords_of(rank)

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"

    def coords_of(self, rank: int) -> dict:
        """Row-major coordinates of global ``rank``, the last axis fastest."""
        out = {}
        for name in reversed(self.axis_names):
            out[name] = rank % self.shape[name]
            rank //= self.shape[name]
        return {name: out[name] for name in self.axis_names}

    def rank_of(self, coords: dict) -> int:
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + coords[name]
        return r

    def _partition(self, subset):
        """The rank lists of ``subset``'s groups, one for each coordinate of
        the other axes, in a fixed order."""
        others = [a for a in self.axis_names if a not in subset]
        for rest in itertools.product(*(range(self.shape[a]) for a in others)):
            fixed = dict(zip(others, rest))
            ranks = []
            for inner in itertools.product(*(range(self.shape[a]) for a in subset)):
                ranks.append(self.rank_of({**fixed, **dict(zip(subset, inner))}))
            yield sorted(ranks)

    def _key(self, entry) -> tuple:
        axes = axes_of(entry)
        unknown = [a for a in axes if a not in self.shape]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} do not name distinct axes of {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def group_ranks(self, entry) -> list:
        """Global ranks of the group over ``entry``'s axes that holds this
        rank, in the group's rank order (global-rank order)."""
        key = self._key(entry)
        return next(r for r in self._partition(key) if self.rank in r)

    def index(self, entry, rank: int | None = None) -> int:
        """``rank``'s (default: this rank's) block index along ``entry``: a
        compound entry counts major-to-minor in the order it lists its axes,
        as ``NamedSharding`` does."""
        c = self.coords if rank is None else self.coords_of(rank)
        i = 0
        for a in axes_of(entry):
            i = i * self.shape[a] + c[a]
        return i

    def axis_size(self, entry) -> int:
        return math.prod(self.shape[a] for a in axes_of(entry))


def axes_of(entry) -> tuple:
    """A spec entry (None, an axis name, or a tuple of names) as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class Mesh(AbstractMesh):
    """The world's ranks as a named mesh.  ``coords``: this rank's index on
    each axis; :meth:`group` the process group of a subset of axes."""

    def __init__(self, sizes, names):
        super().__init__(sizes, names)
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs a world of {self.size} ranks, "
                             f"this one has {world}")
        self.rank = dist.get_rank()
        self.coords = self.coords_of(self.rank)
        self._groups = {}
        for n in range(1, len(names) + 1):
            for subset in itertools.combinations(self.axis_names, n):
                for ranks in self._partition(subset):
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[subset] = (g, ranks)

    def group(self, entry):
        """The process group over ``entry``'s axes that holds this rank."""
        return self._groups[self._key(entry)][0]

    def group_ranks(self, entry) -> list:
        return self._groups[self._key(entry)][1]


def make_mesh(shape, axes) -> Mesh:
    """A mesh over the whole world: the product of ``shape`` must equal
    ``dist.get_world_size()``."""
    return Mesh(tuple(shape), tuple(axes))


def production_shape(multi_pod: bool = False):
    """(sizes, names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 (data, model), or 2 x 16 x 16 (pod, data, model): a world of
    256 or 512 ranks."""
    return make_mesh(*production_shape(multi_pod))


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's shape without a world (the planner's)."""
    return AbstractMesh(*production_shape(multi_pod))
