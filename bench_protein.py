#!/usr/bin/env python
"""Benchmark: protein-scale Gram builds at the reference's
time-to-solution sizes (``example/perfbench/protein-time-to-solution.py``
targets multi-hundred-residue contact maps; SURVEY §5 calls for product
spaces n1*n2 ~ 1e5-1e6).

Three size classes:
  small:  11 x 150-300 residues   (n1*n2 up to ~9e4)
  medium:  6 x 400-600 residues   (n1*n2 up to ~3.6e5)
  large:   4 x 800-1000 residues  (n1*n2 up to ~1e6)

Pairs this large exceed the fused kernel's shared-memory budget, so
``backend='auto'`` solves them with the XLA ``edge`` solver.

Prints ONE JSON line (headline = the large class) with every class and
the card's name and power limit. Needs an NVIDIA GPU.
"""
import json


def bench_class(label, seed, n_graphs, rng_range, reps=3):
    import jax
    import jax.numpy as jnp

    from graphdot_tpu.inference import GramFactory
    from graphdot_tpu.kernel import MarginalizedGraphKernel
    from graphdot_tpu.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct
    )
    from graphdot_tpu.testing import random_protein_set
    from graphdot_tpu.util.card import steady_seconds

    graphs = random_protein_set(seed, n_graphs, n_residues_range=rng_range)
    n_pairs = n_graphs * (n_graphs + 1) // 2
    kernel = MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(3.0)),
        q=0.05,
    )
    factory = GramFactory(kernel, graphs, normalize=True,
                          buckets=False, union=False)
    theta0 = jnp.asarray(factory.theta0, dtype=jnp.float32)
    gram = jax.jit(factory.gram)
    first, dt = steady_seconds(gram, theta0, reps=reps)
    K = gram(theta0)
    assert bool(jnp.all(jnp.isfinite(K))), f'non-finite Gram {label}'
    n_max = max(len(g.nodes) for g in graphs)
    return {
        'label': label, 'n_pairs': n_pairs, 'n1n2_max': n_max ** 2,
        'pairs_per_sec': n_pairs / dt, 'ms_per_build': dt * 1e3,
        'first_call_s': first, 'backend': kernel.backend.mode,
    }


def main():
    from graphdot_tpu.util import enable_compilation_cache
    from graphdot_tpu.util.card import describe
    card = describe()
    enable_compilation_cache()

    rows = [bench_class(label, seed, n, rng) for label, seed, n, rng in [
        ('150-300res', 7, 11, (150, 300)),
        ('400-600res', 8, 6, (400, 600)),
        ('800-1000res', 9, 4, (800, 1000)),
    ]]
    head = rows[-1]
    print(json.dumps({
        'metric': f'protein graph-pairs/s (Gram build, '
                  f'{head["label"]} contact maps, '
                  f'n1*n2 up to {head["n1n2_max"]:.0e})',
        'value': head['pairs_per_sec'],
        'unit': 'pairs/s',
        'vs_baseline': None,
        'classes': rows,
        'card': card,
    }))


if __name__ == '__main__':
    main()
