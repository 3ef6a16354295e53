#!/usr/bin/env python
"""Benchmark: NUTS samples/s over marginalized-graph-kernel GPR
hyperparameters (the second BASELINE.json metric).

Workload: QM7-sized molecule set, GP log-posterior over (p, q, element
prior, length scale), multinomial NUTS with warm-started step size.
Prints one JSON line; chains/s scales with the 'chains' mesh axis on
multi-chip systems.
"""
import json
import time

import numpy as np


def main(n_graphs=32, n_chains=8, n_samples=40, max_depth=6):
    from graphdot_tpu.util import enable_compilation_cache
    from graphdot_tpu.util.card import describe
    card = describe()
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from graphdot_tpu.inference import GPRLogProb, sample
    from graphdot_tpu.kernel import MarginalizedGraphKernel
    from graphdot_tpu.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct
    )
    from graphdot_tpu.testing import random_molecule_set

    graphs = random_molecule_set(7, n_graphs, n_atoms_range=(9, 24))
    rng = np.random.default_rng(0)
    y = np.array([
        -10.0 * len(g.nodes) + rng.normal() for g in graphs
    ])

    kernel = MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(0.3)),
        q=0.05,
    )
    logprob = GPRLogProb(kernel, graphs, y, alpha=1e-2, normalize_y=True)
    init = jnp.asarray(logprob.theta0, dtype=jnp.float32)

    # Warmup run to adapt (step size, mass) and compile everything.
    # 100 steps, not 30: the short warmup adapted to overly-large step
    # sizes whose shallow trees draw fast but mix poorly — raw draws/s
    # rewarded exactly that. ESS/s below is the
    # headline; the longer adaptation maximizes it.
    t0 = time.perf_counter()
    out = sample(
        logprob, jax.random.PRNGKey(0), n_chains=n_chains, n_warmup=100,
        n_samples=2, init=init, max_depth=max_depth, init_jitter=0.05
    )
    t_warm = time.perf_counter() - t0

    # steady-state: resume with fixed step size / mass (no warmup),
    # median over repeats
    from graphdot_tpu.inference import resume_state
    init2, step_size, inv_mass = resume_state(out)
    times = []
    for rep in range(3):
        t0 = time.perf_counter()
        out2 = sample(
            logprob, jax.random.PRNGKey(1 + rep), n_chains=n_chains,
            n_samples=n_samples, init=jnp.asarray(init2),
            step_size=step_size, inv_mass=inv_mass, max_depth=max_depth
        )
        jax.block_until_ready(out2['samples'])
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    total = n_chains * n_samples
    sps = total / dt

    # quality-adjusted throughput: raw draws/s depends strongly on the
    # adapted (step size, mass) — a too-large step size yields shallow
    # trees that draw fast but mix poorly. Bulk ESS/s is invariant to
    # that trade and is the number to track across rounds.
    from graphdot_tpu.inference.diagnostics import ess
    ess_min = float(np.min(ess(np.asarray(out2['samples']))))
    mean_accept = float(np.mean(np.asarray(out2['accept_prob'])))

    print(json.dumps({
        'metric': f'NUTS min-bulk-ESS/s ({n_graphs}-molecule GPR '
                  f'posterior, {n_chains} chains)',
        'value': ess_min / dt,
        'unit': 'ESS/s',
        'vs_baseline': None,      # reference publishes no numbers
        'samples_per_sec': sps,
        'min_ess': ess_min,
        'mean_accept': mean_accept,
        'warmup_and_compile_s': t_warm,
        'backend': kernel.backend.mode,
        'card': card,
    }))


if __name__ == '__main__':
    main()
