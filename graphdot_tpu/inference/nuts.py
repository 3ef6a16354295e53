"""No-U-Turn Sampler (iterative, multinomial), pure jnp and vmappable.

Implements multinomial NUTS (Hoffman & Gelman 2014; Betancourt 2017) with
the checkpoint-based *iterative* tree expansion (Phan & Pradhan 2019) so
the whole transition is expressible with ``lax.while_loop`` — no recursion,
fully jittable, shardable across chains on a device mesh.

U-turn bookkeeping: leaves of a depth-d subtree are visited left-to-right;
leaf m starts a nested subtree iff its low bits are zero, and the live
checkpoint-stack depth at that moment equals popcount(m), so the starting
momentum and running momentum-sum are stored at slot popcount(m). Leaf n
closes subtrees of sizes 2^1..2^t where t = trailing_ones(n), whose
checkpoints live at slots popcount(n)-t .. popcount(n)-1.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .hmc import HMCState, hmc_init  # noqa: F401  (re-exported)

_DIVERGENCE = 1000.0


class _Leaf(NamedTuple):
    q: jnp.ndarray
    p: jnp.ndarray
    grad: jnp.ndarray
    logp: jnp.ndarray


def _leapfrog1(logp_and_grad, leaf, eps, inv_mass):
    p = leaf.p + 0.5 * eps * leaf.grad
    q = leaf.q + eps * inv_mass * p
    logp, grad = logp_and_grad(q)
    p = p + 0.5 * eps * grad
    return _Leaf(q=q, p=p, grad=grad, logp=logp)


def _energy(leaf, inv_mass):
    return -leaf.logp + 0.5 * jnp.sum(inv_mass * leaf.p * leaf.p)


def _popcount(n):
    return lax.population_count(n.astype(jnp.uint32)).astype(jnp.int32)


def _trailing_ones(n):
    u = (n + 1).astype(jnp.uint32)
    return _popcount((u & (~u + jnp.uint32(1))) - jnp.uint32(1))


def _is_turning(rsum, p_start, p_end, inv_mass):
    v = inv_mass * rsum
    return (jnp.dot(v, p_start) <= 0) | (jnp.dot(v, p_end) <= 0)


def _nuts_step_nested(rng, state, logp_fn, step_size, inv_mass,
                      max_depth=8):
    """One NUTS transition (nested-loop reference implementation).

    Kept as the readable specification and as the oracle for the flat
    single-loop implementation below (same RNG fold scheme, so the two
    produce identical transitions); `nuts_step` is the production entry.

    Parameters
    ----------
    rng: PRNG key.
    state: HMCState (q, logp, grad).
    logp_fn: callable q -> log density.
    step_size: float or scalar array.
    inv_mass: [D] diagonal inverse mass.
    max_depth: static maximum tree depth.

    Returns
    -------
    (new_state, info) where info carries accept_prob (dual-averaging
    statistic), divergent flag, tree depth and #leapfrogs.
    """
    logp_and_grad = jax.value_and_grad(logp_fn)
    D = state.q.shape[0]
    k_mom, k_tree = jax.random.split(rng)
    p0 = jax.random.normal(k_mom, (D,)) / jnp.sqrt(inv_mass)
    z0 = _Leaf(q=state.q, p=p0, grad=state.grad, logp=state.logp)
    h0 = _energy(z0, inv_mass)

    def build_subtree(rng, edge, v, depth, eps):
        """Build a subtree of up to 2^depth leaves from ``edge`` in
        direction v; returns the subtree summary."""
        n_leaves = jnp.int32(2) ** depth

        ckpt_r = jnp.zeros((max_depth + 1, D))
        ckpt_rsum = jnp.zeros((max_depth + 1, D))

        init = dict(
            leaf=jnp.int32(0),
            z=edge,
            prop=edge,
            prop_logsumw=-jnp.inf,
            rsum=jnp.zeros(D),
            logsumw=-jnp.inf,
            sum_acc=jnp.float32(0.0),
            ckpt_r=ckpt_r,
            ckpt_rsum=ckpt_rsum,
            turning=jnp.bool_(False),
            divergent=jnp.bool_(False),
        )

        def cond(c):
            return (
                (c['leaf'] < n_leaves)
                & ~c['turning'] & ~c['divergent']
            )

        def body(c):
            n = c['leaf']
            z = _leapfrog1(logp_and_grad, c['z'], v * eps, inv_mass)
            h = _energy(z, inv_mass)
            h = jnp.where(jnp.isnan(h), jnp.inf, h)
            log_w = h0 - h
            divergent = (h - h0) > _DIVERGENCE

            # within-subtree progressive multinomial proposal
            logsumw = jnp.logaddexp(c['logsumw'], log_w)
            k = jax.random.fold_in(rng, n)
            take = jnp.log(
                jax.random.uniform(k)
            ) < log_w - logsumw
            prop = jax.tree_util.tree_map(
                lambda a, b: jnp.where(take, a, b), z, c['prop']
            )

            sum_acc = c['sum_acc'] + jnp.minimum(1.0, jnp.exp(log_w))

            # checkpoint bookkeeping for iterative U-turn checks
            rsum_before = c['rsum']
            rsum = rsum_before + z.p
            pc = _popcount(n)
            is_start = (n % 2) == 0
            ckpt_r = jnp.where(
                is_start,
                c['ckpt_r'].at[pc].set(z.p),
                c['ckpt_r']
            )
            ckpt_rsum = jnp.where(
                is_start,
                c['ckpt_rsum'].at[pc].set(rsum_before),
                c['ckpt_rsum']
            )

            t = _trailing_ones(n)
            idx_hi = pc  # slots pc-t .. pc-1 hold the closing subtrees

            def check(j, turning):
                idx = idx_hi - 1 - j
                active = j < t
                sub_rsum = rsum - ckpt_rsum[idx]
                turn_j = _is_turning(
                    sub_rsum, ckpt_r[idx], z.p, inv_mass
                )
                return turning | (active & turn_j)

            turning = lax.fori_loop(
                0, max_depth + 1, check, jnp.bool_(False)
            )

            return dict(
                leaf=n + 1,
                z=z,
                prop=prop,
                prop_logsumw=logsumw,
                rsum=rsum,
                logsumw=logsumw,
                sum_acc=sum_acc,
                ckpt_r=ckpt_r,
                ckpt_rsum=ckpt_rsum,
                turning=turning,
                divergent=divergent,
            )

        out = lax.while_loop(cond, body, init)
        return out

    init = dict(
        depth=jnp.int32(0),
        z_left=z0,
        z_right=z0,
        prop=z0,
        rsum=p0,
        logsumw=jnp.float32(0.0),
        sum_acc=jnp.float32(0.0),
        n_leapfrog=jnp.int32(0),
        stop=jnp.bool_(False),
        divergent=jnp.bool_(False),
    )

    def cond(c):
        return (c['depth'] < max_depth) & ~c['stop']

    def body(c):
        k_dir = jax.random.fold_in(k_tree, 2 * c['depth'])
        k_sub = jax.random.fold_in(k_tree, 2 * c['depth'] + 1)
        k_swap = jax.random.fold_in(k_tree, 2 * c['depth'] + 11311)
        v = jnp.where(jax.random.bernoulli(k_dir), 1.0, -1.0)
        edge = jax.tree_util.tree_map(
            lambda a, b: jnp.where(v > 0, a, b), c['z_right'], c['z_left']
        )
        sub = build_subtree(k_sub, edge, v, c['depth'], step_size)
        ok = ~sub['turning'] & ~sub['divergent']

        # biased progressive sampling across the doubling
        take = ok & (
            jnp.log(jax.random.uniform(k_swap))
            < sub['logsumw'] - c['logsumw']
        )
        prop = jax.tree_util.tree_map(
            lambda a, b: jnp.where(take, a, b), sub['prop'], c['prop']
        )

        z_left = jax.tree_util.tree_map(
            lambda new, old: jnp.where((v < 0) & ok, new, old),
            sub['z'], c['z_left']
        )
        z_right = jax.tree_util.tree_map(
            lambda new, old: jnp.where((v > 0) & ok, new, old),
            sub['z'], c['z_right']
        )
        rsum = jnp.where(ok, c['rsum'] + sub['rsum'], c['rsum'])
        logsumw = jnp.where(
            ok, jnp.logaddexp(c['logsumw'], sub['logsumw']), c['logsumw']
        )
        whole_turn = _is_turning(
            rsum, z_left.p, z_right.p, inv_mass
        )
        stop = ~ok | whole_turn

        return dict(
            depth=c['depth'] + 1,
            z_left=z_left,
            z_right=z_right,
            prop=prop,
            rsum=rsum,
            logsumw=logsumw,
            sum_acc=c['sum_acc'] + sub['sum_acc'],
            n_leapfrog=c['n_leapfrog'] + sub['leaf'],
            stop=stop,
            divergent=c['divergent'] | sub['divergent'],
        )

    out = lax.while_loop(cond, body, init)
    prop = out['prop']
    new_state = HMCState(q=prop.q, logp=prop.logp, grad=prop.grad)
    info = {
        'accept_prob': out['sum_acc'] / jnp.maximum(
            out['n_leapfrog'].astype(jnp.float32), 1.0
        ),
        'divergent': out['divergent'],
        'depth': out['depth'],
        'n_leapfrog': out['n_leapfrog'],
        'energy': -prop.logp,
    }
    return new_state, info


def nuts_step(rng, state, logp_fn, step_size, inv_mass, max_depth=8):
    """One NUTS transition — flat single-loop implementation.

    Semantically identical to :func:`_nuts_step_nested` (same tree
    scheme, same RNG folds, hence the same transition draw-for-draw),
    but the whole transition is ONE ``lax.while_loop`` advancing exactly
    one leapfrog per iteration. Under ``vmap`` (multi-chain batching on
    one chip) a batched while loop runs all chains in lockstep until the
    slowest finishes, so per-iteration granularity matters: the nested
    doubling/subtree loops execute ~2^(dmax+1) masked leapfrogs per draw
    where dmax is the *deepest* chain's tree, while this loop executes
    only max-over-chains total leapfrogs (~2-3x fewer in practice).

    Parameters and return value as :func:`_nuts_step_nested`.
    """
    logp_and_grad = jax.value_and_grad(logp_fn)
    D = state.q.shape[0]
    k_mom, k_tree = jax.random.split(rng)
    p0 = jax.random.normal(k_mom, (D,)) / jnp.sqrt(inv_mass)
    z0 = _Leaf(q=state.q, p=p0, grad=state.grad, logp=state.logp)
    h0 = _energy(z0, inv_mass)

    init = dict(
        d=jnp.int32(0),               # current doubling
        j=jnp.int32(0),               # leaf index within the subtree
        v=jnp.float32(1.0),           # current direction
        z=z0,                         # integration edge being extended
        z_left=z0,
        z_right=z0,
        prop=z0,                      # tree-level proposal
        logsumw=jnp.float32(0.0),     # tree-level multinomial weight
        rsum=p0,                      # tree-level momentum sum
        sub_prop=z0,
        sub_logsumw=-jnp.inf,
        sub_rsum=jnp.zeros(D),
        ckpt_r=jnp.zeros((max_depth + 1, D)),
        ckpt_rsum=jnp.zeros((max_depth + 1, D)),
        sum_acc=jnp.float32(0.0),
        n_leapfrog=jnp.int32(0),
        depth=jnp.int32(0),           # doubling attempts (for info)
        stop=jnp.bool_(False),
        divergent=jnp.bool_(False),
    )

    def cond(c):
        return ~c['stop'] & (c['d'] < max_depth)

    def body(c):
        d, j, v = c['d'], c['j'], c['v']

        # -- subtree start: pick a direction, reset subtree state -----
        starting = j == 0
        k_dir = jax.random.fold_in(k_tree, 2 * d)
        v_new = jnp.where(jax.random.bernoulli(k_dir), 1.0, -1.0)
        v = jnp.where(starting, v_new, v)
        edge = jax.tree_util.tree_map(
            lambda a, b: jnp.where(v > 0, a, b),
            c['z_right'], c['z_left']
        )
        z = jax.tree_util.tree_map(
            lambda e, zz: jnp.where(starting, e, zz), edge, c['z']
        )
        sub_logsumw = jnp.where(starting, -jnp.inf, c['sub_logsumw'])
        sub_rsum = jnp.where(starting, jnp.zeros(D), c['sub_rsum'])
        depth = c['depth'] + starting.astype(jnp.int32)

        # -- one leapfrog + within-subtree multinomial proposal -------
        z = _leapfrog1(logp_and_grad, z, v * step_size, inv_mass)
        h = _energy(z, inv_mass)
        h = jnp.where(jnp.isnan(h), jnp.inf, h)
        log_w = h0 - h
        divergent = (h - h0) > _DIVERGENCE

        k_sub = jax.random.fold_in(k_tree, 2 * d + 1)
        sub_logsumw_new = jnp.logaddexp(sub_logsumw, log_w)
        take = jnp.log(
            jax.random.uniform(jax.random.fold_in(k_sub, j))
        ) < log_w - sub_logsumw_new
        # the first leaf always seeds the subtree proposal: sub_logsumw
        # is -inf at a subtree start, so take is True by construction
        sub_prop = jax.tree_util.tree_map(
            lambda a, b: jnp.where(take, a, b), z, c['sub_prop']
        )

        sum_acc = c['sum_acc'] + jnp.minimum(1.0, jnp.exp(log_w))

        # -- checkpoint bookkeeping for within-subtree U-turns --------
        rsum_before = sub_rsum
        sub_rsum = rsum_before + z.p
        pc = _popcount(j)
        is_start = (j % 2) == 0
        ckpt_r = jnp.where(
            is_start, c['ckpt_r'].at[pc].set(z.p), c['ckpt_r']
        )
        ckpt_rsum = jnp.where(
            is_start, c['ckpt_rsum'].at[pc].set(rsum_before),
            c['ckpt_rsum']
        )
        t = _trailing_ones(j)

        def check(i, turning):
            idx = pc - 1 - i
            active = i < t
            sub_r = sub_rsum - ckpt_rsum[idx]
            turn_i = _is_turning(sub_r, ckpt_r[idx], z.p, inv_mass)
            return turning | (active & turn_i)

        sub_turning = lax.fori_loop(
            0, max_depth + 1, check, jnp.bool_(False)
        )

        j = j + 1
        n_leapfrog = c['n_leapfrog'] + 1
        n_leaves = jnp.int32(2) ** d
        complete = j >= n_leaves
        aborted = sub_turning | divergent

        # -- doubling merge (only when the subtree completed cleanly) --
        ok = complete & ~aborted
        k_swap = jax.random.fold_in(k_tree, 2 * d + 11311)
        take2 = ok & (
            jnp.log(jax.random.uniform(k_swap))
            < sub_logsumw_new - c['logsumw']
        )
        prop = jax.tree_util.tree_map(
            lambda a, b: jnp.where(take2, a, b), sub_prop, c['prop']
        )
        z_left = jax.tree_util.tree_map(
            lambda new, old: jnp.where((v < 0) & ok, new, old),
            z, c['z_left']
        )
        z_right = jax.tree_util.tree_map(
            lambda new, old: jnp.where((v > 0) & ok, new, old),
            z, c['z_right']
        )
        rsum = jnp.where(ok, c['rsum'] + sub_rsum, c['rsum'])
        logsumw = jnp.where(
            ok, jnp.logaddexp(c['logsumw'], sub_logsumw_new),
            c['logsumw']
        )
        whole_turn = _is_turning(rsum, z_left.p, z_right.p, inv_mass)
        stop = aborted | (complete & (~ok | whole_turn))

        return dict(
            d=d + complete.astype(jnp.int32),
            j=jnp.where(complete, 0, j),
            v=v,
            z=z,
            z_left=z_left,
            z_right=z_right,
            prop=prop,
            logsumw=logsumw,
            rsum=rsum,
            sub_prop=sub_prop,
            sub_logsumw=sub_logsumw_new,
            sub_rsum=sub_rsum,
            ckpt_r=ckpt_r,
            ckpt_rsum=ckpt_rsum,
            sum_acc=sum_acc,
            n_leapfrog=n_leapfrog,
            depth=depth,
            stop=stop,
            divergent=c['divergent'] | divergent,
        )

    out = lax.while_loop(cond, body, init)
    prop = out['prop']
    new_state = HMCState(q=prop.q, logp=prop.logp, grad=prop.grad)
    info = {
        'accept_prob': out['sum_acc'] / jnp.maximum(
            out['n_leapfrog'].astype(jnp.float32), 1.0
        ),
        'divergent': out['divergent'],
        'depth': out['depth'],
        'n_leapfrog': out['n_leapfrog'],
        'energy': -prop.logp,
    }
    return new_state, info
