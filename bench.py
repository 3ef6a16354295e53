#!/usr/bin/env python
"""Benchmark: marginalized-graph-kernel Gram-build throughput on one GPU.

Mirrors the reference's benchmark workload
(``benchmark/kernel/marginalized/time_kernel.py`` /
``example/perfbench/molecule-cookie-cutter.py``): a batch of molecule-like
graphs, full upper-triangular Gram matrix with the Tang2019-style
element/length kernel, steady-state timing (compile excluded).

Prints ONE JSON line: {"metric", "value", "unit", ...} with the card's
name and power limit. Needs an NVIDIA GPU.
"""
import json
import os

import numpy as np


def main():
    from graphdot_tpu.util import enable_compilation_cache
    from graphdot_tpu.util.card import describe, steady_seconds
    card = describe()
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from graphdot_tpu.inference import GramFactory
    from graphdot_tpu.kernel import MarginalizedGraphKernel
    from graphdot_tpu.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct
    )
    from graphdot_tpu.testing import random_molecule_set
    from graphdot_tpu.util.flops import (
        device_peak_flops, gram_flop_report, load_iteration_stats)

    n_graphs = 128
    graphs = random_molecule_set(42, n_graphs, n_atoms_range=(9, 24))
    n_pairs = n_graphs * (n_graphs + 1) // 2
    kernel = MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(0.3)),
        q=0.05,
    )
    factory = GramFactory(kernel, graphs, normalize=True)
    theta0 = jnp.asarray(factory.theta0, dtype=jnp.float32)
    gram = jax.jit(factory.gram)
    compile_s, dt = steady_seconds(gram, theta0, reps=20)
    assert np.all(np.isfinite(np.asarray(gram(theta0)))), \
        'non-finite Gram'

    # useful FLOPs: measured per-pair CG iteration counts (committed
    # cache, scripts/record_bench_iters.py) x the analytic matvec model
    stats = load_iteration_stats(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'tests', 'fixtures',
        'bench_iters_gram.npz'))
    useful = gram_flop_report(factory, theta0, stats=stats)[
        'useful_flops']

    print(json.dumps({
        'metric': 'graph-pairs/s (Gram build, 128 molecules, '
                  'Tang2019 kernel)',
        'value': n_pairs / dt,
        'unit': 'pairs/s',
        'vs_baseline': None,    # the reference publishes no numbers
        'ms_per_build': dt * 1e3,
        'compile_s': compile_s,
        'backend': kernel.backend.mode,
        'useful_gflop_per_build': useful / 1e9,
        'useful_pct_of_tf32_peak':
            100.0 * useful / dt / device_peak_flops(precision='tf32'),
        'card': card,
    }))


if __name__ == '__main__':
    main()
