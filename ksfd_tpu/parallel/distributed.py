"""Multi-process (multi-host) execution support.

The reference runs 16 MPI ranks over 4 nodes (README.txt:5-10,
options84s16.sh); each rank owns a DMDA block and writes its own
HDF5 file '<name>s<size>r<rank>.h5' (KSFD/ksfdtimeseries.py:188-243).

The equivalent here: one JAX *process* per host, all devices
joined into one global mesh by ``jax.distributed``, with XLA SPMD
handling every collective.  Each process writes the slab of the state
it can address locally into its own reference-named slab file
(TimeSeries(ranges=...)); ``tsmerge`` reassembles the global series,
exactly as for reference multi-rank runs.

Launch model (the mpiexec analog):

    KSFD_COORDINATOR=host0:1234 KSFD_NUM_PROCS=4 KSFD_PROC_ID=$i \\
        python ksfdsolver.py @options84 --save=...

or programmatically via ``maybe_init_distributed()`` (called by the
driver before any JAX backend use).
"""

import os

import numpy as np

from ..utils.debug import logger
from ..utils.exceptions import KSFDException

logMESH = logger("MESH")

__all__ = [
    "maybe_init_distributed",
    "process_count",
    "process_index",
    "owned_box",
    "local_values",
    "global_from_local",
]


def maybe_init_distributed(coordinator=None, num_processes=None,
                           process_id=None, local_device_count=None):
    """Initialize jax.distributed from args or KSFD_* environment vars.

    Returns True when a multi-process runtime was initialized.  Must be
    called before any JAX backend use.  No-op when neither args nor
    env vars request distribution.
    """
    coordinator = coordinator or os.environ.get("KSFD_COORDINATOR")
    if num_processes is None and "KSFD_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["KSFD_NUM_PROCS"])
    if process_id is None and "KSFD_PROC_ID" in os.environ:
        process_id = int(os.environ["KSFD_PROC_ID"])
    if not coordinator or num_processes is None or process_id is None:
        return False
    import jax

    if local_device_count is None and "KSFD_LOCAL_DEVICES" in os.environ:
        local_device_count = int(os.environ["KSFD_LOCAL_DEVICES"])
    kwargs = {}
    if local_device_count is not None:
        jax.config.update("jax_num_cpu_devices", local_device_count)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        cluster_detection_method="deactivate",
        **kwargs,
    )
    logMESH(
        "jax.distributed initialized: process", process_id,
        "of", num_processes, "at", coordinator,
    )
    return True


def process_count():
    import jax

    return jax.process_count()


def process_index():
    import jax

    return jax.process_index()


def owned_box(arr):
    """This process's owned block of a global array, as ((lo, hi), ...).

    The union of the process's addressable shards must form one
    contiguous hyperrectangle (true for the row-major grid meshes this
    framework builds); raises otherwise.  Axis 0 (dof) is replicated
    and excluded — the returned ranges cover the SPATIAL axes only.
    """
    shards = arr.addressable_shards
    if not shards:
        raise KSFDException("array has no locally addressable shards")
    ndim = arr.ndim
    los = [arr.shape[d] for d in range(ndim)]
    his = [0] * ndim
    volume = 0
    for sh in shards:
        volume += int(np.prod(sh.data.shape))
        for d, idx in enumerate(sh.index):
            start = idx.start if idx.start is not None else 0
            stop = idx.stop if idx.stop is not None else arr.shape[d]
            los[d] = min(los[d], start)
            his[d] = max(his[d], stop)
    box_volume = int(np.prod([hi - lo for lo, hi in zip(los, his)]))
    if volume != box_volume:
        raise KSFDException(
            "addressable shards do not tile a contiguous box: "
            "%d elements in a %d-element bounding box" % (volume, box_volume)
        )
    if (los[0], his[0]) != (0, arr.shape[0]):
        raise KSFDException(
            "dof axis is sharded; state arrays shard spatial axes only"
        )
    return tuple(zip(los[1:], his[1:]))


def local_values(arr, box=None):
    """Assemble this process's owned block of a global array as numpy.

    Works whether or not the array is fully addressable; only local
    shards are touched (no cross-process gather).
    """
    if box is None:
        box = owned_box(arr)
    lo0 = (0,) + tuple(lo for lo, _ in box)
    shape = (arr.shape[0],) + tuple(hi - lo for lo, hi in box)
    out = np.empty(shape, dtype=arr.dtype)
    for sh in shards_of(arr):
        dest = tuple(
            slice(
                (idx.start or 0) - off,
                (idx.stop if idx.stop is not None else dim) - off,
            )
            for idx, off, dim in zip(sh.index, lo0, arr.shape)
        )
        out[dest] = np.asarray(sh.data)
    return out


def shards_of(arr):
    return arr.addressable_shards


def global_from_local(local, grid, mesh, box=None):
    """Build the global sharded state array from per-process local data.

    ``local`` holds this process's block (all dofs, spatial block as
    given by ``box``; defaults to the block the sharding assigns this
    process).  Single-process: equivalent to device_put.
    """
    import jax
    from .mesh import state_sharding

    sharding = state_sharding(mesh)
    gshape = (grid.dof,) + tuple(grid.nps)
    local = np.asarray(local)
    if jax.process_count() == 1:
        return jax.device_put(local.reshape(gshape), sharding)
    if box is None:
        if local.size == int(np.prod(gshape)):
            # every process holds the full global array (e.g. identical
            # deterministic initial conditions)
            local = local.reshape(gshape)
            box = tuple((0, n) for n in gshape[1:])
        else:
            box = process_box(grid, sharding)
    lo0 = (0,) + tuple(lo for lo, _ in box)

    def fetch(index):
        src = tuple(
            slice(
                (idx.start or 0) - off,
                (idx.stop if idx.stop is not None else dim) - off,
            )
            for idx, off, dim in zip(index, lo0, gshape)
        )
        return local[src]

    return jax.make_array_from_callback(gshape, sharding, fetch)


def process_box(grid, sharding):
    """The block of the global state this process's devices own."""
    import jax

    gshape = (grid.dof,) + tuple(grid.nps)
    mine = [
        idx
        for dev, idx in sharding.devices_indices_map(gshape).items()
        if dev.process_index == jax.process_index()
    ]
    if not mine:
        raise KSFDException("no devices of this process in the sharding")
    ndim = len(gshape)
    los = [gshape[d] for d in range(ndim)]
    his = [0] * ndim
    for index in mine:
        for d, idx in enumerate(index):
            los[d] = min(los[d], idx.start if idx.start is not None else 0)
            his[d] = max(
                his[d], idx.stop if idx.stop is not None else gshape[d]
            )
    return tuple(zip(los[1:], his[1:]))
