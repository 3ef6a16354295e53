#!/usr/bin/env python
"""Record the per-pair CG iteration counts of the Gram bench workload
into a committed .npz cache (consumed by bench.py's FLOP accounting, so
benchmark runs don't pay the instrumented solves' XLA compiles).

Counts are deterministic for a fixed (workload, theta, ftol); re-run
this after changing the solver's tolerance semantics or the bench
workloads.

Run: JAX_PLATFORMS=cpu python scripts/record_bench_iters.py
(the counts are platform-independent).
"""
import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, ROOT)

import numpy as np                                 # noqa: E402
import jax                                         # noqa: E402
jax.config.update('jax_platforms', 'cpu')
import jax.numpy as jnp                            # noqa: E402

from graphdot_tpu.inference import GramFactory     # noqa: E402
from graphdot_tpu.kernel import MarginalizedGraphKernel  # noqa: E402
from graphdot_tpu.microkernel import (             # noqa: E402
    KroneckerDelta, SquareExponential, TensorProduct
)
from graphdot_tpu.testing import random_molecule_set  # noqa: E402
from graphdot_tpu.util.flops import save_iteration_stats  # noqa: E402

FIXDIR = os.path.join(ROOT, 'tests', 'fixtures')


def record_gram():
    graphs = random_molecule_set(42, 128, n_atoms_range=(9, 24))
    kernel = MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(0.3)),
        q=0.05, backend='edge',
    )
    # union=False: the FLOP model wants TRUE per-pair iteration
    # counts, not union super-pair counts
    factory = GramFactory(kernel, graphs, normalize=True,
                          union=False)
    stats = factory.iteration_stats(
        jnp.asarray(factory.theta0, dtype=jnp.float32))
    path = os.path.join(FIXDIR, 'bench_iters_gram.npz')
    save_iteration_stats(path, stats)
    for g in stats:
        print(f"  {g['ca']}x{g['cb']} (m {g['m1']}x{g['m2']}): "
              f"{g['n_jobs']} jobs, iters median "
              f"{np.median(g['iters']):.0f} max {g['iters'].max()}")
    print(f'wrote {path}')


if __name__ == '__main__':
    record_gram()
