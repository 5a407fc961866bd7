"""The (data, gauss, tile) mesh of the multi-device step, over the ranks
of ``torch.distributed``'s default process group (port of
``das3r_tpu/parallel/mesh.py``).

* ``data``: the frames of a step's batch, one per data rank; gradients
  are summed over this axis (the DDP all-reduce);
* ``gauss``: the Gaussian axis; each rank holds its slice of the
  parameters and the Adam moments and preprocesses its slice, whose
  screen-space outputs are gathered before binning;
* ``tile``: the image tiles of each frame; each rank blends one range,
  and the table gradient is summed over the axis.

Ranks are laid out as ``arange(world).reshape(data, gauss, tile)``, as
JAX reshapes its devices, so tile ranks are neighbours. Each axis has one
process group per line of the mesh along it (``new_group``; every rank
creates every group, in one order, as ``new_group`` requires) and a rank
keeps the three that hold it. An axis of size 1 has no group: its
collectives are no communication.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch.distributed as dist

AXES = ("data", "gauss", "tile")


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: dict        # {"data": d, "gauss": g, "tile": t}
    coords: dict       # this rank's index along each axis
    groups: dict       # axis -> process group, None where the size is 1

    def group(self, axis: str):
        return self.groups[axis]


def mesh_shape(n: int, data: int | None = None, tile: int | None = None,
               gauss: int | None = None) -> dict:
    """JAX's defaults for the axes left out: with nothing given,
    everything goes on ``tile``; with exactly one axis missing, it absorbs
    the remainder (``das3r_tpu/parallel/mesh.py:35-49``)."""
    if data is None and tile is None and gauss is None:
        data, gauss, tile = 1, 1, n
    else:
        known = [x for x in (data, gauss, tile) if x is not None]
        rem = n // max(1, int(np.prod(known)))
        if data is None:
            data = rem if (gauss is not None and tile is not None) else 1
        if gauss is None:
            gauss = rem if tile is not None else 1
        if tile is None:
            tile = n // (data * gauss)
    if data * gauss * tile != n:
        raise ValueError(f"mesh (data={data}, gauss={gauss}, tile={tile}) "
                         f"does not cover {n} ranks")
    return {"data": data, "gauss": gauss, "tile": tile}


def make_mesh(data: int | None = None, tile: int | None = None,
              gauss: int | None = None, world_size: int | None = None
              ) -> Mesh:
    """A (data, gauss, tile) mesh over the default process group's ranks.

    With ``world_size`` given, no process group is read or made: the mesh
    of that many ranks as rank 0 sees it, without groups. That is the
    unsharded step's mesh (``world_size=1``) and the shape of any other."""
    if world_size is not None:
        shape = mesh_shape(world_size, data, tile, gauss)
        if world_size > 1 and dist.is_initialized():
            raise ValueError("world_size is for a mesh without a process "
                             "group; a process group is initialized")
        return Mesh(shape=shape, coords={a: 0 for a in AXES},
                    groups={a: None for a in AXES})
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(parallel.multihost.initialize_distributed), "
                           "or world_size")
    n, rank = dist.get_world_size(), dist.get_rank()
    shape = mesh_shape(n, data, tile, gauss)
    ranks = np.arange(n).reshape([shape[a] for a in AXES])
    coords = dict(zip(AXES, (int(c) for c in
                             np.argwhere(ranks == rank)[0])))
    groups = {}
    for ax, axis in enumerate(AXES):
        groups[axis] = None
        if shape[axis] == 1:
            continue
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, shape[axis])
        for line in lines:       # every rank makes every group, in order
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    return Mesh(shape=shape, coords=coords, groups=groups)

