"""Device-mesh helpers — the replacement for the reference's
``multiprocessing.Pool`` process parallelism (SURVEY.md section 2.9).

The embarrassingly-parallel axis of LMC inference is the solve batch:
the observation vector, the Hutchinson probes, and prediction columns
are independent right-hand sides of the same operator. We lay them out
as the leading axis of one array and shard that axis over a 1-D mesh
('probe'); XLA then partitions the whole fused Krylov loop — matvec
FFTs included — with at most scalar collectives for the loop carry.

For very large grids a second mesh axis ('grid') can shard the FFT
axis; one device's memory fits every published benchmark config, so
that path is reserved for larger grids.
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def default_mesh(n_devices=None, axis_name="probe"):
    """1-D mesh over (the first ``n_devices``) local devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def probe_grid_mesh(n_probe, n_grid):
    """2-D mesh ('probe', 'grid'): the solve/probe batch shards over
    'probe'; fft-mode grid matvecs shard their Fourier axis over 'grid'
    (the axis for grids too large for one device's memory)."""
    devices = jax.devices()[: n_probe * n_grid]
    return Mesh(
        np.asarray(devices).reshape(n_probe, n_grid), ("probe", "grid")
    )


def pad_batch(b, n_shards):
    """Pad the leading axis of ``b`` (numpy) with zero rows to a multiple
    of ``n_shards`` (zero RHS rows solve instantly to zero and are
    sliced off by the caller)."""
    B = b.shape[0]
    rem = (-B) % n_shards
    if rem == 0:
        return b, B
    pad = np.zeros((rem,) + b.shape[1:], dtype=b.dtype)
    return np.concatenate([b, pad], axis=0), B


def shard_batch(b, mesh, axis_name="probe"):
    """Place a (B, ...) array with its leading axis sharded over the
    mesh."""
    spec = PartitionSpec(axis_name, *([None] * (b.ndim - 1)))
    return jax.device_put(b, NamedSharding(mesh, spec))


def replicated(x, mesh):
    return jax.device_put(x, NamedSharding(mesh, PartitionSpec()))
