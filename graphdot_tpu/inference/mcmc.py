"""MCMC driver: multi-chain NUTS/HMC with Stan-style warmup windows.

Chains are a leading vmap axis; under a device mesh the same code runs with
chains sharded across chips (see ``graphdot_tpu.parallel``) — adaptation
statistics are pooled across chains by plain means, which lower to psum
collectives when sharded.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .dual_averaging import (
    da_init, da_update, welford_init, welford_update, welford_variance
)
from .hmc import hmc_init, hmc_step
from .nuts import nuts_step


def _transition(algorithm, max_depth, n_leapfrog):
    if algorithm == 'nuts':
        def step(rng, state, logp_fn, step_size, inv_mass):
            return nuts_step(
                rng, state, logp_fn, step_size, inv_mass,
                max_depth=max_depth
            )
    elif algorithm == 'hmc':
        def step(rng, state, logp_fn, step_size, inv_mass):
            return hmc_step(
                rng, state, logp_fn, step_size, inv_mass, n_leapfrog
            )
    else:
        raise ValueError(f'Unknown algorithm {algorithm!r}')
    return step


def _find_reasonable_step_size(logp_fn, state, inv_mass, rng):
    """Crude bracketing of an initial step size via one-step energy error
    (Hoffman & Gelman 2014, Alg. 4 in spirit)."""
    from .nuts import _Leaf, _leapfrog1, _energy
    logp_and_grad = jax.value_and_grad(logp_fn)
    p0 = jax.random.normal(rng, state.q.shape) / jnp.sqrt(inv_mass)
    z0 = _Leaf(q=state.q, p=p0, grad=state.grad, logp=state.logp)
    h0 = _energy(z0, inv_mass)

    def err(eps):
        z = _leapfrog1(logp_and_grad, z0, eps, inv_mass)
        h = _energy(z, inv_mass)
        return jnp.where(jnp.isnan(h), jnp.inf, h) - h0

    def cond(c):
        eps, it = c
        e = err(eps)
        return (e > np.log(2.0)) & (it < 30)

    def body(c):
        eps, it = c
        return (eps * 0.5, it + 1)

    eps, _ = jax.lax.while_loop(cond, body, (jnp.float32(1.0), 0))
    return eps


def sample(logp_fn, rng, n_chains=4, n_warmup=300, n_samples=500,
           init=None, algorithm='nuts', max_depth=8, n_leapfrog=32,
           target_accept=0.8, init_jitter=1.0, thin=1, mesh=None,
           chain_axis='chains', step_size=None, inv_mass=None,
           loop='auto'):
    """Run multi-chain MCMC over ``logp_fn``.

    Parameters
    ----------
    logp_fn: callable [D] -> scalar log density.
    rng: jax PRNG key.
    init: [D] or [n_chains, D] initial positions.
    algorithm: 'nuts' or 'hmc'.
    mesh: optional jax.sharding.Mesh — chains are sharded along
        ``chain_axis`` and each device advances its chains locally, with
        adaptation statistics pooled by cross-chain means (lowered to
        psum collectives).
    loop: 'scan', 'host', or 'auto'
        'scan' compiles the whole warmup/sampling loop into one XLA
        program (lowest dispatch overhead); 'host' drives one jitted
        transition per step from Python, for runtimes where deeply
        nested programs are fragile. 'auto' selects 'scan'.

    Returns
    -------
    dict with 'samples' [n_chains, n_samples, D], 'logp', 'accept_prob',
    'divergent', 'step_size', 'inv_mass'.
    """
    init = jnp.atleast_1d(jnp.asarray(init, dtype=jnp.float32))
    D = init.shape[-1]
    k_init, k_warm, k_sample, k_eps = jax.random.split(rng, 4)
    if init.ndim == 1:
        init = init[None, :] + init_jitter * jax.random.normal(
            k_init, (n_chains, D)
        )
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        n_dev = mesh.shape[chain_axis]
        assert n_chains % n_dev == 0, (
            f'n_chains={n_chains} must be a multiple of the '
            f'{chain_axis!r} mesh axis size {n_dev}'
        )
        init = jax.device_put(
            init, NamedSharding(mesh, PartitionSpec(chain_axis, None))
        )

    if loop == 'auto':
        loop = 'scan'

    step = _transition(algorithm, max_depth, n_leapfrog)
    states = jax.vmap(lambda q: hmc_init(logp_fn, q))(init)

    # resume path: with both adaptation products supplied, skip warmup
    # entirely (see graphdot_tpu.inference.checkpoint.resume_state)
    resume = step_size is not None and inv_mass is not None
    if resume:
        inv_mass = jnp.asarray(inv_mass, dtype=jnp.float32)
        step_size = jnp.float32(step_size)
        n_warmup = 0

    if not resume:
        inv_mass = jnp.ones(D)
        eps0 = _find_reasonable_step_size(
            logp_fn,
            jax.tree_util.tree_map(lambda a: a[0], states),
            inv_mass, k_eps
        )

    @jax.jit
    def one_adapt_step(key, states, da, welford, inv_mass, adapt_mass):
        # adapt_mass is a traced boolean (masked Welford update) so both
        # warmup window flavors share ONE compiled program — these
        # NUTS-loop executables are by far the most expensive compiles
        # of a sampling run
        keys = jax.random.split(key, states.q.shape[0])
        eps = jnp.exp(da.log_step)
        new_states, infos = jax.vmap(
            lambda k, s: step(k, s, logp_fn, eps, inv_mass)
        )(keys, states)
        da = da_update(
            da, jnp.mean(infos['accept_prob']), target=target_accept
        )
        updated = jax.vmap(welford_update)(welford, new_states.q)
        welford = jax.tree_util.tree_map(
            lambda a, b: jnp.where(adapt_mass, a, b), updated, welford
        )
        return new_states, da, welford

    @jax.jit
    def run_window_scan(rng, states, da, welford, inv_mass, n_steps,
                        adapt_mass):
        # n_steps is a traced scalar so that every warmup window reuses
        # ONE compiled program — with the CG solve nested inside NUTS,
        # per-window recompiles would dominate wall time
        def one(i, carry):
            states, da, welford = carry
            key = jax.random.fold_in(rng, i)
            return one_adapt_step(
                key, states, da, welford, inv_mass, adapt_mass
            )

        states, da, welford = jax.lax.fori_loop(
            0, n_steps, one, (states, da, welford)
        )
        return states, da, welford

    def run_window(rng, states, da, welford, inv_mass, n_steps,
                   adapt_mass):
        adapt_mass = jnp.asarray(adapt_mass)
        if loop == 'scan':
            return run_window_scan(
                rng, states, da, welford, inv_mass, n_steps, adapt_mass
            )
        for i in range(int(n_steps)):
            states, da, welford = one_adapt_step(
                jax.random.fold_in(rng, i), states, da, welford,
                inv_mass, adapt_mass
            )
        return states, da, welford

    if resume:
        return _run_sampling_only(
            logp_fn, step, k_sample, states, step_size, inv_mass,
            n_samples, thin, loop
        )

    # Stan-style windows: 15% fast / doubling slow windows / 10% fast
    n_fast1 = max(1, int(0.15 * n_warmup))
    n_fast2 = max(1, int(0.10 * n_warmup))
    n_slow = max(1, n_warmup - n_fast1 - n_fast2)
    windows = []
    w = max(10, n_slow // 8)
    remaining = n_slow
    while remaining > 0:
        take = min(w, remaining)
        # absorb a too-small trailing window
        if remaining - take < 10:
            take = remaining
        windows.append(take)
        w *= 2
        remaining -= take

    da = da_init(eps0)
    welford = jax.vmap(lambda _: welford_init(D))(jnp.arange(n_chains))

    states, da, welford = run_window(
        jax.random.fold_in(k_warm, 0), states, da, welford, inv_mass,
        n_steps=n_fast1, adapt_mass=False
    )
    for wi, wn in enumerate(windows):
        states, da, welford = run_window(
            jax.random.fold_in(k_warm, 1 + wi), states, da, welford,
            inv_mass, n_steps=wn, adapt_mass=True
        )
        var = jnp.mean(
            jax.vmap(welford_variance)(welford), axis=0
        )
        inv_mass = 1.0 / var
        welford = jax.vmap(lambda _: welford_init(D))(
            jnp.arange(n_chains)
        )
        da = da_init(jnp.exp(da.log_step_avg))
    states, da, welford = run_window(
        jax.random.fold_in(k_warm, 999), states, da, welford, inv_mass,
        n_steps=n_fast2, adapt_mass=False
    )
    step_size = jnp.exp(da.log_step_avg)
    return _run_sampling_only(
        logp_fn, step, k_sample, states, step_size, inv_mass,
        n_samples, thin, loop
    )


def _run_sampling_only(logp_fn, step, rng, states, step_size, inv_mass,
                       n_samples, thin, loop='scan'):
    @jax.jit
    def one_sample_step(key, states):
        keys = jax.random.split(key, states.q.shape[0])
        return jax.vmap(
            lambda k, s: step(k, s, logp_fn, step_size, inv_mass)
        )(keys, states)

    if loop == 'host':
        qs, logps, acc, div = [], [], [], []
        for i in range(n_samples):
            for j in range(thin):
                states, infos = one_sample_step(
                    jax.random.fold_in(rng, i * thin + j), states
                )
            qs.append(np.asarray(states.q))
            logps.append(np.asarray(states.logp))
            acc.append(np.asarray(infos['accept_prob']))
            div.append(np.asarray(infos['divergent']))
        qs = jnp.asarray(np.stack(qs))
        logps = jnp.asarray(np.stack(logps))
        infos = {
            'accept_prob': jnp.asarray(np.stack(acc)),
            'divergent': jnp.asarray(np.stack(div)),
        }
    else:
        @partial(jax.jit, static_argnames=('n', 'thin'))
        def run_sampling(rng, states, n, thin):
            def one(states, i):
                def sub(states, j):
                    keys = jax.random.split(
                        jax.random.fold_in(rng, i * thin + j),
                        states.q.shape[0]
                    )
                    new_states, infos = jax.vmap(
                        lambda k, s: step(
                            k, s, logp_fn, step_size, inv_mass
                        )
                    )(keys, states)
                    return new_states, infos
                states, infos = jax.lax.scan(
                    sub, states, jnp.arange(thin)
                )
                infos = jax.tree_util.tree_map(lambda a: a[-1], infos)
                return states, (states.q, states.logp, infos)

            states, (qs, logps, infos) = jax.lax.scan(
                one, states, jnp.arange(n)
            )
            return qs, logps, infos

        qs, logps, infos = run_sampling(rng, states, n_samples, thin)

    return {
        'samples': jnp.swapaxes(qs, 0, 1),      # [chains, samples, D]
        'logp': jnp.swapaxes(logps, 0, 1),
        'accept_prob': jnp.swapaxes(infos['accept_prob'], 0, 1),
        'divergent': jnp.swapaxes(infos['divergent'], 0, 1),
        'step_size': step_size,
        'inv_mass': inv_mass,
    }
