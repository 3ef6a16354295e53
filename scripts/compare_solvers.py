#!/usr/bin/env python
"""Compare the MLGK solvers on one NVIDIA GPU.

On the 128-molecule Gram of ``bench.py`` (8,256 pairs, Tang2019-style
kernel, normalized), for each variant (the XLA ``edge`` solver at a
matmul precision, or the fused kernel):

- accuracy: the unnormalized Gram of all 128 molecules against the
  float64 dense oracle (``tests/oracle.py``), max relative error; and the
  gradient of ``sum(K**2)`` on the first 24 against the same program run
  by XLA on the CPU (the tolerances of ``chip_smoke.py``, phase 2);
- speed: host-clock seconds per Gram build and per gradient of
  ``sum(K**2)``, ending in ``block_until_ready``, compile excluded,
  in alternating order over rounds so that drift hits every variant.

Prints one JSON line per variant and writes all of them, with the card's
name and power limit, to ``chiprun_out/compare_solvers.json``.

Usage: python scripts/compare_solvers.py [--rounds N] [--variants V,...]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, 'tests')]

VARIANTS = ['edge/highest', 'edge/high', 'pallas']


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--rounds', type=int, default=10)
    ap.add_argument('--variants', default=','.join(VARIANTS),
                    help="comma-separated list of 'edge/<precision>' "
                    "and 'pallas'")
    args = ap.parse_args()
    variants = args.variants.split(',')

    import jax
    import jax.numpy as jnp
    from oracle import mlgk
    from graphdot_tpu.inference import GramFactory
    from graphdot_tpu.kernel import MarginalizedGraphKernel
    from graphdot_tpu.kernel.marginalized import _solver
    from graphdot_tpu.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    from graphdot_tpu.testing import random_molecule_set
    from graphdot_tpu.util import enable_compilation_cache
    from graphdot_tpu.util.card import describe
    card = describe()
    enable_compilation_cache()
    graphs = random_molecule_set(42, 128, n_atoms_range=(9, 24))
    knode = TensorProduct(element=KroneckerDelta(0.2))
    kedge = TensorProduct(length=SquareExponential(0.3))
    n = len(graphs)
    want = np.zeros((n, n))
    for i in range(n):
        for j in range(i, n):
            want[i, j] = want[j, i] = mlgk(graphs[i], graphs[j], knode,
                                           kedge, 0.05)
    sub = graphs[:24]
    cpu = jax.devices('cpu')[0]
    with jax.default_device(cpu):
        f_cpu = GramFactory(
            MarginalizedGraphKernel(knode, kedge, q=0.05, backend='edge'),
            sub, normalize=False)
        g_cpu = np.asarray(jax.grad(lambda t: jnp.sum(
            f_cpu.gram(t) ** 2))(jnp.asarray(f_cpu.theta0, jnp.float32)))

    runs = {}
    for name in variants:
        backend, _, precision = name.partition('/')
        _solver.set_solver_precision(precision or 'highest')
        kernel = MarginalizedGraphKernel(knode, kedge, q=0.05,
                                         backend=backend)
        factory = GramFactory(kernel, graphs, normalize=True)
        t0 = jnp.asarray(factory.theta0, dtype=jnp.float32)
        gram = jax.jit(factory.gram)
        grad = jax.jit(jax.grad(
            lambda t, f=factory: jnp.sum(f.gram(t) ** 2)))
        tc = time.perf_counter()
        K = np.asarray(jax.block_until_ready(gram(t0)))
        compile_s = time.perf_counter() - tc
        tc = time.perf_counter()
        jax.block_until_ready(grad(t0))
        grad_compile_s = time.perf_counter() - tc
        f_raw = GramFactory(kernel, graphs, normalize=False)
        K_raw = np.asarray(jax.jit(f_raw.gram)(t0))
        rel = float(np.max(np.abs(K_raw - want) / np.abs(want)))
        f24 = GramFactory(kernel, sub, normalize=False)
        g24 = np.asarray(jax.jit(jax.grad(
            lambda t: jnp.sum(f24.gram(t) ** 2)))(t0))
        grad_ok = bool(np.allclose(g24, g_cpu, rtol=1e-3, atol=1e-4))
        grad_rel = float(np.max(np.abs(g24 - g_cpu) / np.abs(g_cpu)))
        runs[name] = dict(
            backend=backend, precision=precision, gram=gram, grad=grad,
            t0=t0, K=K, compile_s=compile_s,
            grad_compile_s=grad_compile_s, rel_vs_oracle=rel,
            grad_ok=grad_ok, grad_max_rel_vs_cpu=grad_rel,
            groups=[(g['ca'], g['cb'], g['k1'], g['k2'],
                     int(len(g['gi']))) for g in factory._groups],
            gram_s=[], grad_s=[])
        print(json.dumps({'variant': name, 'compile_s': compile_s,
                          'grad_compile_s': grad_compile_s,
                          'rel_vs_oracle': rel, 'grad_ok': grad_ok,
                          'grad_max_rel_vs_cpu': grad_rel}), flush=True)
    _solver.set_solver_precision('highest')

    names = list(runs)
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            run = runs[name]
            for fn, key in ((run['gram'], 'gram_s'),
                            (run['grad'], 'grad_s')):
                tc = time.perf_counter()
                jax.block_until_ready(fn(run['t0']))
                run[key].append(time.perf_counter() - tc)

    K_ref = next(iter(runs.values()))['K']
    out = {'card': card, 'rounds': args.rounds, 'variants': []}
    for name, run in runs.items():
        row = {
            'variant': name,
            'gram_ms_median': 1e3 * float(np.median(run['gram_s'])),
            'gram_ms_iqr': [1e3 * float(q) for q in
                            np.percentile(run['gram_s'], [25, 75])],
            'grad_ms_median': 1e3 * float(np.median(run['grad_s'])),
            'compile_s': run['compile_s'],
            'grad_compile_s': run['grad_compile_s'],
            'rel_vs_oracle': run['rel_vs_oracle'],
            'grad_ok': run['grad_ok'],
            'grad_max_rel_vs_cpu': run['grad_max_rel_vs_cpu'],
            'max_abs_vs_first': float(
                np.max(np.abs(run['K'] - K_ref))),
            'groups': run['groups'],
            'gram_s': run['gram_s'], 'grad_s': run['grad_s'],
        }
        out['variants'].append(row)
        print(json.dumps({k: v for k, v in row.items()
                          if k not in ('gram_s', 'grad_s', 'groups')}),
              flush=True)
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out',
                           'compare_solvers.json'), 'w') as f:
        json.dump(out, f, indent=1)
    print(card['nvidia_smi'])


if __name__ == '__main__':
    main()
