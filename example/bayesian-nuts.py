#!/usr/bin/env python
"""Full NUTS posterior over marginalized-graph-kernel hyperparameters —
the headline new capability of this build (BASELINE.json north star):
instead of the reference's L-BFGS point estimate, sample the posterior of
(p, q, node theta, edge theta) for a GPR over molecules, with chains
vmapped (and shardable across a device mesh)."""
import numpy as np
import jax
import jax.numpy as jnp

from graphdot_tpu.inference import (
    GPRLogProb, ess, sample, split_rhat
)
from graphdot_tpu.kernel import MarginalizedGraphKernel
from graphdot_tpu.microkernel import (
    KroneckerDelta, SquareExponential, TensorProduct
)
from graphdot_tpu.testing import random_molecule_set

graphs = random_molecule_set(0, 12, n_atoms_range=(6, 10))
rng = np.random.default_rng(1)
y = np.array([-10.0 * len(g.nodes) + rng.normal() for g in graphs])

kernel = MarginalizedGraphKernel(
    TensorProduct(element=KroneckerDelta(0.2)),
    TensorProduct(length=SquareExponential(0.3)),
    q=0.05,
    # backend='auto' (the default) runs the fused PCG kernel on a GPU,
    # primal and gradient solves alike, and the XLA solver elsewhere
)
logprob = GPRLogProb(kernel, graphs, y, alpha=1e-2, normalize_y=True)

out = sample(
    logprob, jax.random.PRNGKey(0), n_chains=2, n_warmup=100,
    n_samples=100, init=jnp.asarray(logprob.theta0, dtype=jnp.float32),
    max_depth=5, init_jitter=0.1
)
s = np.asarray(out['samples'])
flat = s.reshape(-1, s.shape[-1])
names = ['log p', 'log q', 'log h(element)', 'log sigma(length)']
print('hyperparameter posterior (log scale):')
for i, name in enumerate(names[:flat.shape[1]]):
    print(f'  {name:18s} {flat[:, i].mean():+.3f} +- '
          f'{flat[:, i].std():.3f}')
print('split-Rhat:', np.round(split_rhat(out['samples']), 3))
print('ESS:', np.round(ess(out['samples']), 1))
print('divergences:', int(np.asarray(out["divergent"]).sum()))

# posterior-predictive at the training graphs via the traced predictor
predict = jax.jit(logprob.predict_fn(graphs[:4]))
thetas = flat[rng.choice(len(flat), 32)]
means = np.stack([
    np.asarray(predict(jnp.asarray(t, dtype=jnp.float32))[0])
    for t in thetas
])
print('posterior-predictive mean at first 4 graphs:',
      means.mean(0).round(2))
print('targets:', y[:4].round(2))
