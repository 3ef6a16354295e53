#!/usr/bin/env python
"""Smoke run of the marginalized graph kernel system on NVIDIA GPUs.

Drives the main paths once through the public API with ``backend='auto'``
and checks what comes out:

1. the 128-molecule Gram of ``bench.py`` (8,256 pairs) and its
   hyperparameter gradient, against the plain XLA ``edge`` solver at full
   width;
2. a 24-molecule subset against the float64 dense oracle
   (``tests/oracle.py``), and its gradient against the same program on the
   CPU;
3. GPR ``fit`` (a few L-BFGS-B steps) and ``predict`` on 640 molecules;
4. the GP log-density and its gradient batched over 3 chains against
   the ``edge`` solver, then a few NUTS transitions over the 32-molecule
   GPR posterior of ``bench_nuts.py``, 8 chains;
5. a protein-sized Gram, whose pairs exceed the fused kernel's
   shared-memory budget and take the XLA ``edge`` solver.

``--four`` runs only the multi-card paths on four GPUs (pairs-sharded
Gram, chain-sharded NUTS, row-sharded GP solve), each against its
one-card run, and no other phase.

Every phase prints one JSON line. The last line of standard output is
``{"ok": true, "device": {...}}``; any failure exits non-zero before it.
Needs one GPU (four with ``--four``) and exits non-zero without one.

Usage: python chip_smoke.py [--four]
"""
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_Q = 0.05


def log(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def timed(fn, *args, reps=5):
    """(compile+first-call seconds, median steady seconds, output)."""
    from graphdot_tpu.util.card import steady_seconds
    return (*steady_seconds(fn, *args, reps=reps), fn(*args))


def molecule_kernel(backend='auto'):
    from graphdot_tpu.kernel import MarginalizedGraphKernel
    from graphdot_tpu.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    return MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(0.3)),
        q=KERNEL_Q, backend=backend)


def groups_of(factory):
    return [dict(ca=g['ca'], cb=g['cb'], k1=g['k1'], k2=g['k2'],
                 jobs=int(len(g['gi'])))
            for g in factory._groups or ()]


def grad_fn(factory):
    import jax
    import jax.numpy as jnp
    return jax.jit(jax.grad(lambda t: jnp.sum(factory.gram(t) ** 2)))


def phase_gram(n_graphs=128):
    import jax
    import jax.numpy as jnp
    from graphdot_tpu.inference import GramFactory
    from graphdot_tpu.testing import random_molecule_set

    graphs = random_molecule_set(42, n_graphs, n_atoms_range=(9, 24))
    kernel = molecule_kernel()
    factory = GramFactory(kernel, graphs, normalize=True)
    t0 = jnp.asarray(factory.theta0, dtype=jnp.float32)
    c_K, s_K, K = timed(jax.jit(factory.gram), t0)
    c_g, s_g, g = timed(grad_fn(factory), t0)
    K, g = np.asarray(K), np.asarray(g)
    assert K.shape == (n_graphs, n_graphs) and np.all(np.isfinite(K))
    assert np.allclose(np.diag(K), 1.0, atol=1e-5)
    assert np.allclose(K, K.T) and np.all(np.isfinite(g))
    # the plain XLA solver at the same width is the reference for the
    # fused kernel
    ref = GramFactory(molecule_kernel('edge'), graphs, normalize=True)
    K_ref = np.asarray(jax.jit(ref.gram)(t0))
    g_ref = np.asarray(grad_fn(ref)(t0))
    dK = float(np.max(np.abs(K - K_ref)))
    dg = float(np.max(np.abs(g - g_ref) / (np.abs(g_ref) + 1e-4)))
    log('gram', mode=kernel.backend.mode, pairs=len(factory._iu),
        groups=groups_of(factory), compile_s=c_K, steady_s=s_K,
        grad_compile_s=c_g, grad_steady_s=s_g,
        max_abs_vs_edge=dK, grad_max_rel_vs_edge=dg)
    assert dK <= 1e-4, f'Gram differs from the edge solver by {dK}'
    assert dg <= 1e-3, f'gradient differs from the edge solver by {dg}'


def phase_oracle(n_graphs=24):
    import jax
    import jax.numpy as jnp
    from graphdot_tpu.inference import GramFactory
    from graphdot_tpu.kernel.marginalized import _solver
    from graphdot_tpu.testing import random_molecule_set
    sys.path.insert(0, os.path.join(HERE, 'tests'))
    from oracle import mlgk

    graphs = random_molecule_set(42, 128, n_atoms_range=(9, 24))[
        :n_graphs]
    kernel = molecule_kernel()
    factory = GramFactory(kernel, graphs, normalize=False)
    t0 = jnp.asarray(factory.theta0, dtype=jnp.float32)
    K = np.asarray(jax.jit(factory.gram)(t0))
    g = np.asarray(grad_fn(factory)(t0))
    want = np.zeros((n_graphs, n_graphs))
    for i in range(n_graphs):
        for j in range(i, n_graphs):
            want[i, j] = want[j, i] = mlgk(
                graphs[i], graphs[j], kernel.node_kernel,
                kernel.edge_kernel, KERNEL_Q)
    rel = float(np.max(np.abs(K - want) / np.abs(want)))

    cpu = jax.devices('cpu')[0]
    with jax.default_device(cpu):
        on_cpu = GramFactory(molecule_kernel('edge'), graphs,
                             normalize=False)
        g_cpu = np.asarray(grad_fn(on_cpu)(jax.device_put(t0, cpu)))
    grad_ok = np.allclose(g, g_cpu, rtol=1e-3, atol=1e-4)
    log('oracle', mode=kernel.backend.mode, pairs=len(factory._iu),
        max_rel_vs_float64_oracle=rel,
        grad_max_abs_vs_cpu=float(np.max(np.abs(g - g_cpu))),
        xla_precision=str(_solver._PRECISION),
        default_matmul_precision=str(
            jax.config.jax_default_matmul_precision))
    assert rel <= 1e-4, f'max relative error vs oracle {rel} > 1e-4'
    assert grad_ok, 'theta-gradient differs from the CPU run'


def phase_gpr(n_train=512, n_test=128):
    from scipy.optimize import minimize
    from graphdot_tpu.kernel.fix import Normalization
    from graphdot_tpu.model.gaussian_process import (
        GaussianProcessRegressor)
    from graphdot_tpu.testing import random_molecule_set

    graphs = random_molecule_set(3, n_train + n_test,
                                 n_atoms_range=(9, 24))
    rng = np.random.default_rng(3)
    y = np.array([-10.0 * len(g.nodes) + rng.normal() for g in graphs])

    def few_lbfgs(fun, x0, args=(), jac=None, bounds=None, tol=None,
                  **_):
        # a fit capped at a few steps: stopping at the cap is success
        res = minimize(fun, x0, args=args, jac=jac, bounds=bounds,
                       tol=tol, method='L-BFGS-B', options={'maxiter': 3})
        res.success = res.success or res.nit == 3
        return res

    kernel = Normalization(molecule_kernel())
    gpr = GaussianProcessRegressor(kernel, alpha=1e-2, normalize_y=True,
                                   optimizer=few_lbfgs)
    t0 = time.perf_counter()
    gpr.fit(graphs[:n_train], y[:n_train])
    fit_s = time.perf_counter() - t0
    assert gpr._engine is not None, 'GramFactory engine not in use'
    t0 = time.perf_counter()
    mean, std = gpr.predict(graphs[n_train:], return_std=True)
    predict_s = time.perf_counter() - t0
    assert mean.shape == std.shape == (n_test,)
    assert np.all(np.isfinite(mean)) and np.all(np.isfinite(std))
    # the posterior mean again, from the kernel's own Grams and a
    # float64 solve on the host
    y_tr = y[:n_train]
    K = gpr.kernel(graphs[:n_train]).astype(np.float64)
    Ks = gpr.kernel(graphs[n_train:], graphs[:n_train])
    w = np.linalg.solve(K + gpr.alpha * np.eye(n_train),
                        (y_tr - y_tr.mean()) / y_tr.std())
    want = Ks @ w * y_tr.std() + y_tr.mean()
    dmean = float(np.max(np.abs(mean - want)) / y_tr.std())
    log('gpr', mode=kernel.kernel.backend.mode, train=n_train,
        test=n_test, fit_s=fit_s, predict_s=predict_s,
        rmse=float(np.sqrt(np.mean((mean - y[n_train:]) ** 2))),
        target_std=float(np.std(y[n_train:])), mean_vs_host_solve=dmean,
        theta=[float(t) for t in gpr.kernel.theta])
    assert dmean < 1e-3, f'posterior mean differs by {dmean} std'


def nuts_posterior(n_graphs=32, backend='auto'):
    from graphdot_tpu.inference import GPRLogProb
    from graphdot_tpu.testing import random_molecule_set
    graphs = random_molecule_set(7, n_graphs, n_atoms_range=(9, 24))
    rng = np.random.default_rng(0)
    y = np.array([-10.0 * len(g.nodes) + rng.normal() for g in graphs])
    kernel = molecule_kernel(backend)
    return kernel, GPRLogProb(kernel, graphs, y, alpha=1e-2,
                              normalize_y=True)


def batched_logprob(logprob, qs):
    """vmap(value_and_grad) of a log-density over the rows of ``qs``, as
    the sampler drives it across chains."""
    import jax
    v, g = jax.jit(jax.vmap(jax.value_and_grad(logprob)))(qs)
    return np.asarray(v), np.asarray(g)


def deviation(a, ref):
    """max |a - ref| / (|ref| + 1): allclose's test with rtol = atol."""
    return float(np.max(np.abs(a - ref) / (np.abs(ref) + 1.0)))


def phase_nuts(n_chains=8, n_compared=3):
    import jax
    import jax.numpy as jnp
    from graphdot_tpu.inference import GPRLogProb, GramFactory, sample
    from graphdot_tpu.testing import random_molecule_set

    # the log-density and its gradient batched over chains through the
    # fused kernel, against the plain XLA solver: first on the posterior
    # of the CPU test of this path, at its tolerances
    graphs = random_molecule_set(3, 4, n_atoms_range=(8, 12))
    y = np.random.default_rng(0).normal(size=4)
    lps = [GPRLogProb(molecule_kernel(be), graphs, y, alpha=1e-2)
           for be in ('auto', 'edge')]
    t0 = jnp.asarray(lps[0].theta0, jnp.float32)
    qs = t0[None, :] + 0.01 * jax.random.normal(
        jax.random.PRNGKey(0), (n_compared, t0.shape[0]))
    (v, g), (v_ref, g_ref) = (batched_logprob(lp, qs) for lp in lps)
    dv, dg = deviation(v, v_ref), deviation(g, g_ref)
    log('nuts_vmap', mode=lps[0].factory.kernel.backend.mode,
        graphs=len(graphs), chains=n_compared, logp_dev_vs_edge=dv,
        grad_dev_vs_edge=dg)
    assert np.all(np.isfinite(v)) and np.all(np.isfinite(g))
    assert dv <= 1e-4, f'batched log-density differs from edge by {dv}'
    assert dg <= 1e-3, f'batched gradient differs from edge by {dg}'

    # then on the sampled posterior. Its K + alpha I is far worse
    # conditioned, and two float32 solvers agree on the gradient only as
    # far as that allows: the values are held to 1e-4, and the
    # gradient's deviation is printed beside that of the XLA solver on
    # the CPU, the float32 floor for this posterior
    kernel, logprob = nuts_posterior()
    _, ref = nuts_posterior(backend='edge')
    init = jnp.asarray(logprob.theta0, dtype=jnp.float32)
    qs = init[None, :] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(2), (n_compared, init.shape[0]))
    v, g = batched_logprob(logprob, qs)
    v_ref, g_ref = batched_logprob(ref, qs)
    cpu = jax.devices('cpu')[0]
    with jax.default_device(cpu):
        _, on_cpu = nuts_posterior(backend='edge')
        _, g_cpu = batched_logprob(on_cpu, jax.device_put(qs, cpu))
    K = np.asarray(GramFactory(molecule_kernel('edge'), ref.factory.graphs)
                   .gram(init), np.float64)
    dv = deviation(v, v_ref)
    log('nuts_vmap', mode=kernel.backend.mode, graphs=len(K),
        chains=n_compared, logp_dev_vs_edge=dv,
        grad_dev_vs_edge=deviation(g, g_ref),
        grad_dev_edge_gpu_vs_cpu=deviation(g_ref, g_cpu),
        cond_K_alpha=float(np.linalg.cond(K + 1e-2 * np.eye(len(K)))))
    assert np.all(np.isfinite(v)) and np.all(np.isfinite(g))
    assert dv <= 1e-4, f'batched log-density differs from edge by {dv}'

    t0 = time.perf_counter()
    out = sample(logprob, jax.random.PRNGKey(0), n_chains=n_chains,
                 n_warmup=10, n_samples=5, init=init, max_depth=4,
                 init_jitter=0.05)
    jax.block_until_ready(out['samples'])
    seconds = time.perf_counter() - t0
    logp = np.asarray(out['logp'])
    accept = float(np.mean(np.asarray(out['accept_prob'])))
    log('nuts', mode=kernel.backend.mode, chains=n_chains,
        samples=list(np.asarray(out['samples']).shape), seconds=seconds,
        mean_accept=accept, logp_range=[float(logp.min()),
                                        float(logp.max())])
    assert np.all(np.isfinite(logp)), 'non-finite log-probabilities'
    assert np.all(np.isfinite(np.asarray(out['samples'])))


def phase_protein(n_graphs=4):
    import jax
    import jax.numpy as jnp
    from graphdot_tpu.inference import GramFactory
    from graphdot_tpu.kernel import MarginalizedGraphKernel
    from graphdot_tpu.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    from graphdot_tpu.ops.pallas_pcg import fits
    from graphdot_tpu.testing import random_protein_set

    graphs = random_protein_set(5, n_graphs, n_residues_range=(150, 300))
    kernel = MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(3.0)), q=KERNEL_Q)
    factory = GramFactory(kernel, graphs, normalize=True)
    t0 = jnp.asarray(factory.theta0, dtype=jnp.float32)
    c, s, K = timed(jax.jit(factory.gram), t0, reps=2)
    K = np.asarray(K)
    b = factory._batch
    m, n = b['esrc'].shape[1], factory._n_pad
    log('protein', mode=kernel.backend.mode, graphs=n_graphs,
        residues=[len(g.nodes) for g in graphs], edges_pad=int(m),
        fused_fits=bool(fits(m, m, n, n)), compile_s=c, steady_s=s)
    assert np.all(np.isfinite(K)) and np.allclose(np.diag(K), 1.0,
                                                  atol=1e-5)
    assert np.all((K > 0) & (K <= 1.0 + 1e-5)) and np.allclose(K, K.T)


def four_cards(devices, n_graphs=128):
    """The pairs-sharded Gram, chain-sharded NUTS and row-sharded GP
    solve on ``devices`` (four), each against its one-device run."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from graphdot_tpu.inference import GramFactory, hmc_init, nuts_step
    from graphdot_tpu.parallel import (
        make_mesh, sharded_gp_solve, sharded_gram_fn)
    from graphdot_tpu.testing import random_molecule_set

    graphs = random_molecule_set(42, n_graphs, n_atoms_range=(9, 24))
    kernel = molecule_kernel()
    factory = GramFactory(kernel, graphs, normalize=True)
    t0 = jnp.asarray(factory.theta0, dtype=jnp.float32)
    mesh = make_mesh({'pairs': 4}, devices=devices)
    with mesh:
        K4 = sharded_gram_fn(factory, mesh, axis='pairs')(t0)
        K4.block_until_ready()
    spread = sorted(d.id for d in K4.sharding.device_set)
    peaks = [d.memory_stats().get('peak_bytes_in_use', 0)
             if d.memory_stats() else 0 for d in devices]
    with jax.default_device(devices[0]):
        K1 = np.asarray(jax.jit(factory.gram)(t0))
    dK = float(np.max(np.abs(np.asarray(K4) - K1)))
    log('four_gram', mode=kernel.backend.mode, mesh={'pairs': 4},
        devices=spread, peak_bytes=peaks, max_abs_dK=dK)
    assert len(spread) == 4, f'sharded Gram on devices {spread}'
    # nothing of the sharded build gathers on the first card: its peak
    # is within a quarter of the busiest other card's
    assert min(peaks) > 0 and peaks[0] <= 1.25 * max(peaks[1:]), \
        f'device 0 peak {peaks[0]} bytes against {peaks[1:]}'
    assert dK < 1e-5, f'sharded Gram deviates by {dK}'

    # row-sharded GP solve of the same Gram
    y = np.random.default_rng(4).normal(size=len(graphs))
    x4 = np.asarray(sharded_gp_solve(mesh, jnp.asarray(K1),
                                     jnp.asarray(y, jnp.float32), 1e-2))
    want = np.linalg.solve(K1.astype(np.float64) + 1e-2 * np.eye(len(y)),
                           y)
    dx = float(np.max(np.abs(x4 - want)) / np.max(np.abs(want)))
    log('four_gp_solve', mesh={'pairs': 4}, max_rel_dx=dx)
    assert dx < 1e-3, f'sharded GP solve deviates by {dx}'

    # chains-sharded NUTS transitions against the unsharded vmap, on the
    # posterior of the earlier multi-device dry run: 16 molecules of
    # 5-17 atoms, standard-normal targets
    from graphdot_tpu.inference import GPRLogProb
    small = random_molecule_set(1, 64, n_atoms_range=(5, 18))[:16]
    y = np.random.default_rng(2).normal(size=64)[:16]
    logprob = GPRLogProb(kernel, small, y, alpha=1e-4)
    q0 = jnp.asarray(logprob.theta0, dtype=jnp.float32)
    n_chains = 8
    mesh2 = make_mesh({'pairs': 2, 'chains': 2}, devices=devices)
    init = q0[None, :] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(0), (n_chains, q0.shape[0]))
    states = jax.vmap(lambda q: hmc_init(logprob, q))(init)
    inv_mass = jnp.ones(q0.shape[0])

    @jax.jit
    def step(keys, states):
        return jax.vmap(lambda k, s: nuts_step(
            k, s, logprob, jnp.float32(0.05), inv_mass, max_depth=4)
        )(keys, states)

    keys = jax.random.split(jax.random.PRNGKey(1), n_chains)
    host = jax.tree_util.tree_map(np.asarray, states)

    def on_chains(a):
        return jax.device_put(a, NamedSharding(
            mesh2, P('chains', *([None] * (np.ndim(a) - 1)))))
    with mesh2:
        new, info = step(on_chains(keys),
                         jax.tree_util.tree_map(on_chains, host))
        new.q.block_until_ready()
    with jax.default_device(devices[0]):
        ref, _ = step(jnp.asarray(keys),
                      jax.tree_util.tree_map(jnp.asarray, host))
    dq = float(np.max(np.abs(np.asarray(new.q) - np.asarray(ref.q))))
    log('four_nuts', mode=kernel.backend.mode,
        mesh={'pairs': 2, 'chains': 2}, chains=n_chains,
        devices=sorted(d.id for d in new.q.sharding.device_set),
        accept=float(np.mean(np.asarray(info['accept_prob']))),
        max_abs_dq=dq)
    assert np.all(np.isfinite(np.asarray(new.logp)))
    assert dq < 1e-5, f'sharded NUTS chains deviate by {dq}'


def main(argv):
    four = '--four' in argv
    import jax
    devices = jax.devices()
    if devices[0].platform != 'gpu':
        print(f'chip_smoke: no GPU (JAX platform '
              f'{devices[0].platform!r})', file=sys.stderr)
        return 2
    from graphdot_tpu.util.card import describe  # fails outside the repo
    card = describe()
    log('card', jax=jax.__version__, **card)
    if four:
        if len(devices) < 4:
            print(f'chip_smoke --four: {len(devices)} GPUs',
                  file=sys.stderr)
            return 2
        four_cards(devices[:4])
    else:
        for phase in (phase_gram, phase_oracle, phase_gpr, phase_nuts,
                      phase_protein):
            t0 = time.perf_counter()
            phase()
            log(phase.__name__, seconds=time.perf_counter() - t0)
    print(card['nvidia_smi'])
    print(json.dumps({'ok': True, 'device': {
        'platform': devices[0].platform,
        'kind': devices[0].device_kind,
        'count': len(devices)}}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
