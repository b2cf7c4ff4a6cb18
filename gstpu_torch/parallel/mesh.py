"""The (data, model) mesh of the multi-device path, over torch.distributed.

Port of ``gstpu/parallel/mesh.py``.  Axes:

- ``data``: the camera batch; gradients are summed over it;
- ``model``: the Gaussians (parameters and Adam moments are split over it)
  and the image's tile rows (each rank rasterizes a round-robin band).  The
  forward all-gathers the parameters over ``model``; the all-gather's
  backward is the reduce-scatter of the Gaussians' gradients.

One process is one rank.  Rank r sits at ``(r // n_model, r % n_model)``, as
the JAX package reshapes its device list into the mesh.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: the process group of the ranks
    that share this rank's other coordinate (None when the axis has one
    rank), the axis size, this rank's index on it, and the global ranks of
    the group by index."""
    group: object
    size: int
    index: int
    ranks: tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an ``n_data`` x ``n_model`` mesh of ranks."""
    n_data: int
    n_model: int
    rank: int
    data: Axis
    model: Axis

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def coords(self) -> tuple:
        """(data index, model index) of this rank."""
        return self.data.index, self.model.index

    def axis(self, name: str) -> Axis:
        if name not in ("data", "model"):
            raise ValueError(f"no mesh axis {name!r}: the axes are 'data' "
                             "and 'model'")
        return getattr(self, name)


def make_mesh(n_data: int | None = None, n_model: int | None = None) -> Mesh:
    """A (data, model) mesh over the ranks of the default process group (one
    rank when none is initialized).

    Defaults: every rank on the model axis.  Every rank creates every
    group, in the same order, as ``dist.new_group`` requires.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None and n_model is None:
        n_data, n_model = 1, world
    elif n_data is None:
        n_data = world // n_model
    elif n_model is None:
        n_model = world // n_data
    if n_data * n_model != world:
        raise ValueError(f"a mesh of {n_data} x {n_model} ranks over "
                         f"{world} processes")
    d, m = divmod(rank, n_model)
    rows = [tuple(i * n_model + j for j in range(n_model))
            for i in range(n_data)]
    cols = [tuple(i * n_model + j for i in range(n_data))
            for j in range(n_model)]

    def groups(members):
        # single-rank axes need no group; all ranks skip them alike
        if len(members[0]) == 1:
            return [None] * len(members)
        return [dist.new_group(list(ranks)) for ranks in members]

    model_groups, data_groups = groups(rows), groups(cols)
    return Mesh(n_data=n_data, n_model=n_model, rank=rank,
                data=Axis(data_groups[m], n_data, d, cols[m]),
                model=Axis(model_groups[d], n_model, m, rows[d]))
