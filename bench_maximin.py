#!/usr/bin/env python
"""Benchmark: MaxiMin graph-distance matrix throughput.

Workload mirrors the reference's MaxiMin use case
(``graphdot/metric/maximin/_maximin.py`` + ``_backend.cu:40-408``; used
by the active-learning / metric examples): the full pairwise distance
matrix over a batch of molecule-like graphs, where each entry is a
maximin reduction over the nodal similarity matrix the solver returns.

The headline number times the fully on-device pipeline
(``MaxiMin.device_distance_fn``: all nodal pair solves + the masked
maximin reduction in one jitted program) on the host clock, ending in
``block_until_ready``. The host-orchestrated ``metric(graphs)`` path
(per-size-class chunks + numpy reduction + hotspot gradients) is
reported alongside. Needs an NVIDIA GPU.
"""
import json
import time

import numpy as np


def main(n_graphs=128, reps=3):
    from graphdot_tpu.util import enable_compilation_cache
    from graphdot_tpu.util.card import describe, steady_seconds
    card = describe()
    enable_compilation_cache()

    from graphdot_tpu.metric import MaxiMin
    from graphdot_tpu.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct
    )
    from graphdot_tpu.testing import random_molecule_set

    graphs = random_molecule_set(11, n_graphs, n_atoms_range=(9, 24))
    metric = MaxiMin(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(0.3)),
        q=0.05,
    )
    n_pairs = n_graphs * (n_graphs + 1) // 2

    # --- device-side pipeline ---
    import jax
    fn, theta0 = metric.device_distance_fn(graphs)
    fn = jax.jit(fn)
    D_dev = np.asarray(fn(theta0))

    D = metric(graphs)  # host-orchestrated path, warm up / compile
    assert D.shape == (n_graphs, n_graphs)
    # the solver's float32 CG tolerance (~1e-6 in k) appears as ~sqrt
    # of that in the induced distance, so the self-distance floor is ~1e-3
    assert np.all(np.isfinite(D)) and np.allclose(np.diag(D), 0, atol=5e-3)
    # device pipeline must agree with the host-orchestrated path
    drift = float(np.max(np.abs(D_dev - D)))
    assert drift < 5e-3, f'device-vs-host maximin drift {drift}'

    _, dt_dev = steady_seconds(fn, theta0, reps=10)

    # host-orchestrated wall time (what an interactive user of the
    # sklearn-style API sees)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        metric(graphs)
        times.append(time.perf_counter() - t0)
    dt_host = float(np.median(times))

    # gradient-path timing (hotspot-restricted analytic gradient)
    t0 = time.perf_counter()
    _, dD = metric(graphs, eval_gradient=True)
    dt_grad = time.perf_counter() - t0
    assert np.all(np.isfinite(dD))

    print(json.dumps({
        'metric': f'MaxiMin distance matrix ({n_graphs} molecules)',
        'value': n_pairs / dt_dev,
        'unit': 'graph-pairs/s',
        'details': {
            'ms_per_matrix_device': dt_dev * 1e3,
            'ms_per_matrix_host_dispatched': dt_host * 1e3,
            'ms_per_matrix_with_gradient': dt_grad * 1e3,
            'device_vs_host_drift': drift,
            'n_pairs': n_pairs,
            'backend': metric.backend.mode,
        },
        'card': card,
    }))


if __name__ == '__main__':
    main()
