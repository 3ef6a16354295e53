#!/usr/bin/env python
"""Protein-scale Gram matrix: contact-map graphs with hundreds of
residues, where the product space n1*n2 reaches 1e4-1e6.

Pairs this large exceed the fused kernel's shared-memory budget, so
``backend='auto'`` solves them with the XLA edge solver, on a GPU and on
the CPU alike; ``backend='kron'`` factorizes the smooth edge kernel
instead. See bench_protein.py for the timed version.
"""
import numpy as np

from graphdot_tpu.inference import GramFactory
from graphdot_tpu.kernel import MarginalizedGraphKernel
from graphdot_tpu.microkernel import (
    KroneckerDelta, SquareExponential, TensorProduct
)
from graphdot_tpu.testing import random_protein_set

graphs = random_protein_set(seed=0, n_graphs=4,
                            n_residues_range=(80, 120))
print('residues:', [len(g.nodes) for g in graphs])
print('contacts:', [len(g.edges) for g in graphs])

kernel = MarginalizedGraphKernel(
    TensorProduct(element=KroneckerDelta(0.2)),
    TensorProduct(length=SquareExponential(3.0)),
    q=0.05,
)

import jax
import jax.numpy as jnp

factory = GramFactory(kernel, graphs, normalize=True, buckets=False)
K = np.asarray(
    jax.jit(factory.gram)(jnp.asarray(factory.theta0, jnp.float32))
)
print('normalized Gram:')
print(np.array_str(K, precision=4, suppress_small=True))
assert np.allclose(np.diagonal(K), 1.0, atol=1e-4)
