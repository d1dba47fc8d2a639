"""Hybrid-parallel topology (after ``paddle_tpu/distributed/topology.py``).

The 5-D logical grid ``("dp", "pp", "sharding", "sep", "mp")`` with ``mp``
fastest-varying. The reference makes it a ``jax.sharding.Mesh``; here it is
a ``torch.distributed`` ``DeviceMesh`` with the same dim names, whose
per-dim process groups are the groups :class:`HybridCommunicateGroup`
hands out. Rank ``r`` sits at the same coordinate in both, since both lay
the ranks out row-major.
"""
from __future__ import annotations

import itertools
import math
from typing import List, Optional, Sequence

__all__ = ["HYBRID_AXES", "CommunicateTopology", "HybridCommunicateGroup",
           "Group", "build_mesh"]

HYBRID_AXES = ("dp", "pp", "sharding", "sep", "mp")


class CommunicateTopology:
    def __init__(self, hybrid_group_names: Sequence[str] = HYBRID_AXES,
                 dims: Sequence[int] = (1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = list(itertools.product(*(range(d) for d in dims)))
        self._coord2rank = {c: i for i, c in enumerate(self.coordinate)}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return math.prod(self._dims)

    def get_rank(self, **kwargs) -> int:
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return self._coord2rank[coord]

    def get_coord(self, rank: int):
        return self.coordinate[rank]

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """All groups along ``axis_name``: ranks that differ only in that
        coordinate."""
        axis = self._parallel_names.index(axis_name)
        other_axes = [i for i in range(len(self._dims)) if i != axis]
        groups = []
        for other in itertools.product(*(range(self._dims[i])
                                         for i in other_axes)):
            ranks = []
            for v in range(self._dims[axis]):
                coord = list(other)
                coord.insert(axis, v)
                ranks.append(self._coord2rank[tuple(coord)])
            groups.append(ranks)
        return groups


class Group:
    """A communication group: its member ranks, this rank's index among
    them, the mesh axis it spans (or None) and its ``torch.distributed``
    process group (None for the whole world)."""

    def __init__(self, ranks: List[int], axis_name: Optional[str] = None,
                 rank: int = 0, process_group=None):
        self.ranks = list(ranks)
        self.axis_name = axis_name
        self.rank = rank
        self.nranks = len(self.ranks)
        self.process_group = process_group

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, global_rank: int) -> int:
        return self.ranks.index(global_rank)

    def __repr__(self):
        return f"Group(axis={self.axis_name}, ranks={self.ranks})"


class HybridCommunicateGroup:
    """Degrees, coordinates and groups of this rank in the topology. With a
    ``mesh`` (the one :func:`build_mesh` made for the same degrees) each
    group carries that mesh dim's process group."""

    def __init__(self, topology: CommunicateTopology, global_rank: int = 0,
                 mesh=None):
        self._topo = topology
        self._mesh = mesh
        self.global_rank = global_rank
        self.nranks = topology.world_size()
        self._dp_degree = topology.get_dim("dp")
        self._pp_degree = topology.get_dim("pp")
        self._sharding_degree = topology.get_dim("sharding")
        names = topology.get_hybrid_group_names()
        self._sep_degree = topology.get_dim("sep") if "sep" in names else 1
        self._mp_degree = topology.get_dim("mp")
        self._coord = dict(zip(names, topology.get_coord(global_rank)))

    # ---- degrees
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    # ---- ranks within groups
    def get_data_parallel_rank(self):
        return self._coord["dp"]

    def get_model_parallel_rank(self):
        return self._coord["mp"]

    def get_stage_id(self):
        return self._coord["pp"]

    get_pipe_parallel_rank = get_stage_id

    def get_sharding_parallel_rank(self):
        return self._coord["sharding"]

    def get_sep_parallel_rank(self):
        return self._coord["sep"]

    # ---- groups
    def _group(self, axis: str) -> Group:
        names = self._topo.get_hybrid_group_names()
        others = {k: v for k, v in self._coord.items() if k != axis}
        ranks = [r for r in range(self.nranks)
                 if all(self._topo.get_coord(r)[names.index(k)] == v
                        for k, v in others.items())]
        pg = self._mesh.get_group(axis) if self._mesh is not None else None
        return Group(ranks, axis_name=axis, rank=self._coord[axis],
                     process_group=pg)

    def get_data_parallel_group(self):
        return self._group("dp")

    def get_model_parallel_group(self):
        return self._group("mp")

    def get_pipe_parallel_group(self):
        return self._group("pp")

    def get_sharding_parallel_group(self):
        return self._group("sharding")

    def get_sep_parallel_group(self):
        return self._group("sep")

    def topology(self):
        return self._topo


def build_mesh(dp=1, pp=1, sharding=1, sep=1, mp=1, device_type=None):
    """The hybrid ``DeviceMesh`` over the whole world, dims named
    ``HYBRID_AXES`` (``mp`` fastest-varying, as the reference orders its
    devices). Every rank calls it, since each dim's process groups are made
    collectively. ``device_type`` defaults to the world's device."""
    from torch.distributed.device_mesh import init_device_mesh

    from .parallel import get_device, get_world_size

    if device_type is None:
        device_type = get_device().type
    need = dp * pp * sharding * sep * mp
    world = get_world_size()
    if need != world:
        raise ValueError(
            f"mesh needs {need} ranks (dp{dp}*pp{pp}*sharding{sharding}"
            f"*sep{sep}*mp{mp}) but the world has {world}")
    return init_device_mesh(device_type, (dp, pp, sharding, sep, mp),
                            mesh_dim_names=HYBRID_AXES)
