"""Device mesh helpers.

This build's two parallel axes (SURVEY.md §2.9): 'pairs' — Gram-tile /
graph-pair data parallelism — and 'chains' — MCMC chain / SMC particle
parallelism. Multi-host meshes come for free from jax.devices() spanning
hosts after jax.distributed.initialize().
"""
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Initialize multi-host JAX. After this, ``jax.devices()`` spans
    all hosts and :func:`make_mesh` builds meshes across them. Pass the
    coordinator address (``host:port``), process count and process id;
    no-op when already initialized."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if 'already initialized' not in str(e):
            raise


def make_mesh(axes=None, devices=None):
    """Create a named mesh over the available devices.

    Parameters
    ----------
    axes: dict name -> size, with at most one -1 (inferred), or None for a
        1-D {'pairs': n_devices} mesh.
    devices: explicit device list (defaults to jax.devices()).
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if axes is None:
        axes = {'pairs': n}
    names = list(axes.keys())
    sizes = list(axes.values())
    n_infer = sizes.count(-1)
    assert n_infer <= 1
    if n_infer:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    assert int(np.prod(sizes)) == n, (
        f'Mesh axes {dict(zip(names, sizes))} do not cover {n} devices.'
    )
    dev_array = np.asarray(devices).reshape(sizes)
    return Mesh(dev_array, names)


def replicated(mesh):
    return NamedSharding(mesh, P())


def sharded_along(mesh, axis, ndim=1):
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))
