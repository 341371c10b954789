"""Device mesh construction and sharding helpers.

NO reference counterpart — the reference is strictly single-GPU
(survey §2.6: `cudaGLSetGLDevice(0)` src/main.cpp:175, no NCCL/MPI).
This framework scales over a 1-D `jax.sharding.Mesh`; XLA hands the
collectives to NCCL, which on one host runs them over NVLink (every card
reaches every other at the same rate, so the mesh follows the algorithm
alone).  The host network is only touched at host boundaries (image
ingest, checkpoints).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

DATA_AXIS = "data"

_dist_initialized = False


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> int:
    """Multi-host wiring: `jax.distributed.initialize` from args or the
    standard env (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID, or a cluster-autodetected environment).

    Call once per process BEFORE any jax computation; afterwards
    `jax.devices()` spans every host and `make_mesh`/`make_global_mesh`
    build meshes whose collectives run within a host over NVLink and
    across hosts over the network (see make_global_mesh).  No-op (returns process count)
    when single-process or already initialized.
    """
    global _dist_initialized
    import os

    if _dist_initialized:
        return jax.process_count()
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        _dist_initialized = True  # single-process: nothing to do
        return 1
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _dist_initialized = True
    return jax.process_count()


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the first n_devices local devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n_devices]), (axis,))


def make_global_mesh(axis: str = DATA_AXIS) -> Mesh:
    """1-D mesh over ALL global devices (every process's chips).

    Multi-host: device order is chosen host-major via
    `mesh_utils.create_hybrid_device_mesh`, so a sharded axis keeps
    each host's block contiguous — point/observation shards stay on
    the host that loaded them and the per-matvec [M,6] psums become a
    hierarchical in-host reduce + small cross-host exchange (XLA handles
    the decomposition given this ordering).  Single-process: identical to
    make_mesh().
    """
    if jax.process_count() == 1:
        return make_mesh(axis=axis)
    # Host-major device order.  (Not mesh_utils.create_hybrid_device_mesh:
    # that helper partitions by accelerator *slice* and rejects the
    # common 1-slice multi-host topology — and any CPU cluster — with
    # "Number of slices 1 must equal ..."; exercised by
    # tests/test_multihost.py's real 2-process cluster.)
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs), (axis,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def sharded_leading(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def put_replicated(mesh: Mesh, x):
    """Global replicated array from a host value every process holds."""
    return jax.device_put(x, replicated(mesh))


def put_sharded(mesh: Mesh, x, axis: str = DATA_AXIS):
    """Global leading-dim-sharded array from the FULL host value (every
    process passes the same complete array; each keeps only its
    shards).  For multi-host pipelines where each process only holds
    its own block, use `put_local_shards` instead."""
    return jax.device_put(x, sharded_leading(mesh, axis))


def put_local_shards(mesh: Mesh, x_local, axis: str = DATA_AXIS):
    """Global leading-dim-sharded array assembled from per-process
    local blocks (each process passes ONLY its [n_global/n_proc, ...]
    slice) — the multi-host ingest path: data loaded on the host that
    owns it never crosses DCN."""
    return jax.make_array_from_process_local_data(
        sharded_leading(mesh, axis), np.asarray(x_local)
    )


def gather_to_one(tree, mesh: Mesh):
    """A mesh program's results as ONE copy on the mesh's first device.

    A replicated shard_map output holds one buffer per device.  Code
    run on it afterwards would run replicated on every device, and on a
    GPU, where scatter-adds and reductions are not bitwise
    reproducible, those copies drift apart: the host then reads device
    0's copy while the next mesh program uses each device's own.
    Single-device code after a mesh stage therefore starts from device
    0's copy (replicated leaves) or from the gathered array (sharded
    leaves)."""
    dev = mesh.devices.flat[0]

    def one(x):
        if x.sharding.is_fully_replicated:
            for s in x.addressable_shards:
                if s.device == dev:
                    return s.data
            return x.addressable_shards[0].data
        return jax.device_put(x, dev)

    return jax.tree.map(one, tree)


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m
