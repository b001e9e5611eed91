"""Device mesh + sharding for the grid: the DMDA replacement.

The reference decomposes the grid across MPI ranks with PETSc DMDA and
exchanges stencil_width-deep halos before every RHS/Jacobian evaluation
(KSFD/ksfdsym.py:919-920; SURVEY §2 'Parallelism strategies').  Here
the SAME decomposition is expressed declaratively: the state array
(dof, nx[, ny[, nz]]) gets a NamedSharding over a Mesh whose axes
split the spatial dimensions, and XLA's SPMD partitioner inserts the
halo collective-permutes for the shifted stencil reads and the
all-reduces of the spectral preconditioner's basis transforms.
Periodic wraparound is the collective-permute from the last shard to
the first.
"""

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ..utils.debug import logger

logMESH = logger("MESH")

__all__ = [
    "grid_mesh",
    "state_sharding",
    "distribute",
    "mesh_shape_for",
    "sharding_mesh",
]

SPATIAL_AXES = ("x", "y", "z")


def mesh_shape_for(n_devices, grid_dims, nps=None):
    """Split n_devices over up to grid_dims mesh axes.

    Choosing the decomposition is the framework's job (the reference's
    DMDA picks its own process grid, KSFD/ksfdgrid.py:388-411).  For
    2D/3D grids an X-ONLY split (slabs) is preferred whenever the
    devices divide nx: the block preconditioner's sharded apply
    (linalg.make_sharded_block_apply) contracts only the x axis
    locally and needs ONE all-reduce per apply on an x-only mesh, and
    slabs exchange halos with two neighbours only.  Falls back to the
    most-balanced factoring otherwise (or when nps is unknown).  nps
    (points per axis) also caps each mesh axis so a tiny grid never
    gets oversharded.
    """
    if grid_dims == 1:
        shape = [n_devices]
    elif (
        nps is not None
        and n_devices > 1
        and int(nps[0]) % n_devices == 0
    ):
        shape = [n_devices] + [1] * (grid_dims - 1)
    else:
        # factor n_devices into grid_dims parts, most-balanced first
        shape = [1] * grid_dims
        n = n_devices
        f = 2
        factors = []
        while f * f <= n:
            while n % f == 0:
                factors.append(f)
                n //= f
            f += 1
        if n > 1:
            factors.append(n)
        for fac in sorted(factors, reverse=True):
            # multiply into the currently smallest axis (keeps balance)
            i = int(np.argmin(shape))
            shape[i] *= fac
    if nps is not None:
        # never more shards than points per axis, and each axis count
        # must DIVIDE the points (device_put rejects uneven shards) —
        # halve until both hold, idling surplus devices instead of
        # crashing tiny/odd grids on big meshes
        for i in range(grid_dims):
            npts = max(1, int(nps[i]))
            while shape[i] > 1 and (shape[i] > npts or npts % shape[i]):
                shape[i] //= 2
    return tuple(shape)


def grid_mesh(grid, devices=None, shape=None):
    """A Mesh over the grid's spatial axes.

    devices: defaults to jax.devices().
    shape: mesh shape per spatial axis; auto-factored when None.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = mesh_shape_for(n, grid.dim, grid.nps)
    used = int(np.prod(shape))
    axis_names = SPATIAL_AXES[: grid.dim]
    dev_array = np.asarray(devices[:used]).reshape(shape)
    logMESH("mesh shape", shape, "over", used, "devices")
    return Mesh(dev_array, axis_names)


def state_sharding(mesh):
    """NamedSharding for a state array (dof unsharded, space sharded)."""
    spec = PartitionSpec(None, *mesh.axis_names)
    return NamedSharding(mesh, spec)


def distribute(u, grid, devices=None, mesh=None, shape=None):
    """Place a state array onto the device mesh.  Returns (u, mesh).

    Everything downstream (jitted step, RHS, FFT preconditioner) is
    sharding-transparent: XLA propagates the sharding and inserts the
    halo exchanges.
    """
    if mesh is None:
        mesh = grid_mesh(grid, devices=devices, shape=shape)
    sharded = jax.device_put(u, state_sharding(mesh))
    return sharded, mesh


def sharding_mesh(u):
    """The Mesh behind an array's NamedSharding over >1 device, or None."""
    sh = getattr(u, "sharding", None)
    if isinstance(sh, NamedSharding) and len(sh.device_set) > 1:
        return sh.mesh
    return None
