"""Device-mesh utilities for multi-chip solves.

The reference has no distributed layer at all (SURVEY.md §2 "parallelism
inventory": single host, single device).  This module is the comm layer:
mesh construction, named shardings for the packed problem containers, and
host helpers to place a problem on the mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

OBS_AXIS = "obs"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = OBS_AXIS,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """1-D mesh over the observation axis (the BA analog of data parallel).

    For BA the observation axis is the only large, embarrassingly-reducible
    axis, so a flat mesh is enough; the cards of one host reach each other
    all to all over NVLink, so the mesh follows the algorithm alone.
    """
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def mesh_key(mesh: Mesh) -> tuple:
    """Hashable identity of a mesh by its CONTENT (device ids, axis layout).

    Solver caches must not key on ``id(mesh)``: a garbage-collected Mesh's
    address can be reused by a new Mesh, which would return a jitted solver
    closed over the dead mesh's device layout.
    """
    return (
        tuple(d.id for d in mesh.devices.flat),
        mesh.devices.shape,
        mesh.axis_names,
    )


def obs_sharding(mesh: Mesh, axis_name: str = OBS_AXIS) -> NamedSharding:
    """Sharding for flat observation arrays: leading axis split over mesh."""
    return NamedSharding(mesh, P(axis_name))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_ba_problem(problem, mesh: Mesh, axis_name: str = OBS_AXIS):
    """Place a BAProblem on the mesh: obs arrays sharded, the rest replicated.

    The obs padding produced by the packers is a multiple of 1024, so any
    mesh size up to 1024 divides it.
    """
    import jax.tree_util as jtu

    from tpu3drecon.problems.packing import BAProblem

    obs = obs_sharding(mesh, axis_name)
    rep = replicated_sharding(mesh)

    from tpu3drecon.utils.placement import sharded_put

    def place(x, sharded: bool):
        return sharded_put(x, obs if sharded else rep)

    return BAProblem(
        cameras=jtu.tree_map(lambda x: place(x, False), problem.cameras),
        points3d=place(problem.points3d, False),
        cam_idx=place(problem.cam_idx, True),
        pt_idx=place(problem.pt_idx, True),
        uv=place(problem.uv, True),
        mask=place(problem.mask, True),
        avg_cam_width=place(problem.avg_cam_width, False),
    )
