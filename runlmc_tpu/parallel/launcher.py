"""Multi-host runtime entry point.

The reference's only cross-machine story is SLURM array jobs over
INDEPENDENT benchmark configs (reference benchmarks/benchlib/
slurm-wrapper.sh:1-25) — no single model ever spans machines. Here ONE
SPMD program runs across every host: each host initializes the
distributed runtime, builds the same model, and passes a global mesh;
``jax.sharding`` + GSPMD insert the cross-device collectives (SURVEY.md
section 7 stage 8).

Single-process use (tests, one device, one host) degenerates to a
no-op: ``initialize()`` without a coordinator leaves JAX untouched and
``global_mesh`` falls back to local devices.

Launch recipe (one command per host; the rendezvous is always
explicit)::

    # host i of H:
    COORD=10.0.0.2:8476 NPROC=H PROC_ID=$i python train.py

where ``train.py`` begins::

    import runlmc_tpu.parallel as par
    par.initialize()                      # no-op on a single host
    mesh = par.global_mesh(axis_name="probe")
    model = InterpolatedLLGP(..., mesh=mesh)
    model.optimize()                      # same program at any scale

Every host must execute the same sequence of jitted calls with the
same shapes — the model API already guarantees this (training is a
deterministic chunk schedule; host-side stopping-rule replay is
deterministic given identical device results).
"""

import logging
import os

import jax
import numpy as np
from jax.sharding import Mesh

_LOG = logging.getLogger(__name__)

_INITIALIZED = False


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, **kwargs):
    """Initialize the multi-host runtime (idempotent).

    Arguments default from the environment (``COORD``, ``NPROC``,
    ``PROC_ID``). When neither arguments nor environment name a
    coordinator and a process count, this is a no-op and the program
    stays single-host (the degenerate mode the test suite runs).

    Returns True when a distributed runtime was started.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return True
    coordinator_address = coordinator_address or os.environ.get("COORD")
    if num_processes is None and "NPROC" in os.environ:
        num_processes = int(os.environ["NPROC"])
    if process_id is None and "PROC_ID" in os.environ:
        process_id = int(os.environ["PROC_ID"])

    # Decide WITHOUT touching the XLA backend —
    # jax.distributed.initialize() must run before anything that
    # initializes it (jax.devices, jax.default_backend, any
    # computation).
    explicit = coordinator_address is not None and num_processes is not None
    if not explicit:
        _LOG.info(
            "parallel.initialize: single-process run (no coordinator "
            "configured) — distributed runtime not started"
        )
        return False
    if process_id is None:
        # jax.distributed.initialize(process_id=None) fails with an
        # opaque error deep in the rendezvous. Name the missing knob of
        # the documented COORD/NPROC/PROC_ID recipe.
        raise ValueError(
            "parallel.initialize: COORD/NPROC set but no process id — "
            "set PROC_ID=<i> (or pass process_id=)"
        )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    _INITIALIZED = True
    _LOG.info(
        "parallel.initialize: process %d/%d, %d global devices "
        "(%d local)",
        jax.process_index(), jax.process_count(),
        len(jax.devices()), len(jax.local_devices()),
    )
    return True


def global_mesh(axis_name="probe", grid_axis=None):
    """A mesh over ALL devices of the (possibly multi-host) runtime.

    ``grid_axis``: optional size of a second 'grid' axis (grid-sharded
    fft matvecs; SURVEY.md section 7 stage 8) — devices are laid out so
    the 'grid' axis falls INSIDE a host wherever possible (its
    collectives are per-matvec all-to-alls and should stay on the
    host's device interconnect, while the batch axis has none).
    """
    devices = np.asarray(jax.devices())
    if grid_axis is None or grid_axis == 1:
        return Mesh(devices, (axis_name,))
    if len(devices) % grid_axis:
        raise ValueError(
            "device count %d not divisible by grid_axis %d"
            % (len(devices), grid_axis)
        )
    return Mesh(
        devices.reshape(len(devices) // grid_axis, grid_axis),
        (axis_name, "grid"),
    )


def is_distributed():
    return _INITIALIZED
