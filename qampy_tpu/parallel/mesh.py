"""Mesh helpers for time-axis sharding, single- and multi-process.

Single process: ``make_mesh(n)`` builds a 1-D mesh over the local devices.
Multi-process (multi-host): call
``init_distributed`` FIRST in every process, then ``make_mesh()`` — after
``jax.distributed.initialize`` the device list is global, every process
runs the same program (multi-controller SPMD) and the shard_map chains in
``parallel.sharded`` compile unchanged, with XLA routing collectives over
the device links within a host (NVLink on a GPU host) and the network
across hosts. This replaces the
reference's vestigial ZMQ worker pool (qampy/core/processing.py:41-149)
with the JAX runtime's process-spanning mesh.
"""
from __future__ import annotations

import numpy as np
import jax

#: canonical mesh axis name for the waveform time axis
TIME = "t"


def time_axis():
    return TIME


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_count=None,
                     platform=None, cpu_collectives="gloo"):
    """Initialise the multi-process JAX runtime (call before any backend use).

    On a cluster whose runtime JAX detects, call with no arguments; on a
    plain GPU host pass ``coordinator_address`` ("localhost:<port>"),
    ``num_processes`` and ``process_id``. For CPU-hosted runs (tests,
    the 2-host-shaped integration test) pass ``coordinator_address``
    ("host:port"), ``num_processes``, ``process_id`` and
    ``local_device_count`` (virtual CPU devices per process); cross-process
    collectives use the ``cpu_collectives`` implementation ("gloo" here;
    "mpi" where an MPI runtime exists).

    After this returns, ``jax.devices()`` is the GLOBAL device list and
    ``make_mesh()`` builds a process-spanning mesh.
    """
    if platform == "cpu" or local_device_count is not None:
        # config API: it takes effect even where JAX_PLATFORMS names
        # another platform
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation",
                          cpu_collectives)
    if local_device_count is not None:
        jax.config.update("jax_num_cpu_devices", int(local_device_count))
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=int(num_processes),
                      process_id=int(process_id))
    jax.distributed.initialize(**kwargs)


def make_mesh(n_devices=None, devices=None):
    """Create a 1-D mesh over the time axis.

    Uses ``jax.devices()`` — the GLOBAL list when ``init_distributed`` /
    ``jax.distributed.initialize`` ran first, so the same call builds a
    process-spanning mesh in multi-controller mode. On a single device
    this degrades to a trivial mesh (the shard_map kernels still compile).
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return jax.sharding.Mesh(np.asarray(devices), (TIME,))
