"""What a measurement ran on: JAX's device and, on a GPU, the card's
name and power limit as ``nvidia-smi`` reports them (a card set below
its maximum power runs slower under load)."""
import subprocess


def describe(require_gpu=True):
    """``{'platform', 'kind', 'count'}`` of ``jax.devices()``, plus
    ``'nvidia_smi'`` (name and power limit) on a GPU. With
    ``require_gpu``, a host without a GPU is an error: a time taken
    there is not a device measurement."""
    import jax
    devices = jax.devices()
    out = {'platform': devices[0].platform,
           'kind': devices[0].device_kind, 'count': len(devices)}
    if out['platform'] != 'gpu':
        if require_gpu:
            raise RuntimeError(
                f'no GPU: JAX platform is {out["platform"]!r}')
        return out
    out['nvidia_smi'] = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    return out


def steady_seconds(fn, *args, reps=10):
    """Host-clock seconds of ``fn(*args)`` per call, ending in
    ``block_until_ready``: the first call (compilation) and the median
    of ``reps`` later calls."""
    import time

    import jax
    import numpy as np
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times))
