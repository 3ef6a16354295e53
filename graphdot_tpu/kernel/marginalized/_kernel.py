"""Marginalized graph kernel — host-side orchestration.

API parity with the reference ``graphdot/kernel/marginalized/_kernel.py:17``
(``__call__``, ``diag``, sklearn-compatible ``theta``/``bounds``/
``clone_with_theta``), rebuilt on JAX:

- The job list (upper-triangular or rectangular index set,
  reference ``_kernel.py:170-183``) becomes static chunks of pair indices
  gathered on-device; all pairs in a chunk are solved simultaneously by
  the batched CG in :mod:`._solver` with static padded shapes.
- Hyperparameter gradients use JAX forward-mode autodiff through the
  implicit linear solve — replacing both the reference's analytic adjoint
  (``compute_duo``) and its finite-difference theta grids.
- Graph-to-device conversion is cached per graph in ``graph.cookie``
  (same policy as ``_backend_cuda.py:111-116``).
"""
import copy
import numbers
import warnings
from collections import namedtuple


import numpy as np
import jax
import jax.numpy as jnp

from ...graph import Graph
from ...graph.batch import batch_graphs
from ...util import Timer
from ...util.iterable import fold_like, flatten
from ...util.pretty_tuple import pretty_tuple
from ._backend import backend_factory
from ._solver import mlgk_solve, weight_by_p
from .starting_probability import StartingProbability, Uniform, Adhoc


def _kernel_structure(k):
    """A hashable key describing a microkernel's expression-tree structure
    (excluding hyperparameter values). Two kernels with equal structure
    trace to identical XLA programs, so their jitted solvers can be
    shared."""
    if hasattr(k, 'kw_kernels'):
        return (
            'Composite', k.opstr,
            tuple(
                (key, _kernel_structure(sub))
                for key, sub in k.kw_kernels.items()
            )
        )
    name = k.name
    if name in ('Add', 'Multiply', 'Exponentiation'):
        return (name, _kernel_structure(k.k1), _kernel_structure(k.k2))
    if name == 'Normalize':
        return ('Normalize', _kernel_structure(k.kernel))
    if name == 'Convolution':
        return ('Convolution', bool(k.mean), _kernel_structure(k.kernel))
    return (name, k.n_theta)


#: structural key -> jitted solver; shared across kernel instances so that
#: e.g. a hyperparameter sweep does not retrace per instance
_GLOBAL_FN_CACHE = {}


class MarginalizedGraphKernel:
    """Implements the random-walk-based graph similarity kernel proposed
    in Kashima, Tsuda & Inokuchi (ICML 2003) and accelerated per Tang &
    de Jong (2019).

    Parameters
    ----------
    node_kernel: microkernel
        Computes the similarity between individual nodes.
    edge_kernel: microkernel
        Computes the similarity between individual edges.
    p: positive number (default=1.0) or StartingProbability
        The starting probability of the random walk on each node.
    q: float in (0, 1)
        The probability for the random walk to stop during each step.
    q_bounds: pair of floats
        Optimization bounds of q.
    eps, ftol, gtol: floats
        eps is retained for API parity (the reference's finite-difference
        step size; unused — gradients are exact here). ftol is the CG
        convergence tolerance of the kernel-value solve (stop at
        sqrt(rTr) < ftol * N); gtol is the (usually looser) tolerance of
        the gradient solves, as in the reference backend.
    dtype: numpy dtype of returned matrices.
    backend: 'auto', 'edge', 'dense', or a Backend instance.
    """

    trait_t = namedtuple(
        'Traits', 'diagonal, symmetric, nodal, lmin, eval_gradient'
    )

    @classmethod
    def traits(cls, diagonal=False, symmetric=False, nodal=False, lmin=0,
               eval_gradient=False):
        return cls.trait_t(diagonal, symmetric, nodal, lmin, eval_gradient)

    def __init__(self, node_kernel, edge_kernel, p=1.0, q=0.01,
                 q_bounds=(1e-4, 1 - 1e-4), eps=1e-2, ftol=1e-8, gtol=1e-6,
                 dtype=np.float64, backend='auto', buckets=False):
        self.buckets = buckets
        self.node_kernel = node_kernel
        self.edge_kernel = edge_kernel
        self.p = self._get_starting_probability(p)
        self.q = q
        self.q_bounds = q_bounds
        self.eps = eps
        self.ftol = ftol
        self.gtol = gtol
        self.element_dtype = dtype
        self.backend = backend_factory(backend)
        self._fn_cache = {}

        if self.node_kernel.minmax[0] <= 0 or self.node_kernel.minmax[1] > 1:
            warnings.warn(
                'Node kernel value range should be within (0, 1], '
                f'got {self.node_kernel.minmax} for {self.node_kernel}. '
                'Consider adding a small constant or using the '
                '`.normalized` attribute of the kernel.',
                DeprecationWarning
            )
        if self.edge_kernel.minmax[0] < 0 or self.edge_kernel.minmax[1] > 1:
            warnings.warn(
                'Edge kernel value range must be within [0, 1], '
                f'got {self.edge_kernel.minmax} for {self.edge_kernel}. '
                'Consider adding a small constant or using the '
                '`.normalized` attribute of the kernel.',
                DeprecationWarning
            )

    def _get_starting_probability(self, p):
        if isinstance(p, StartingProbability):
            return p
        elif isinstance(p, tuple) and len(p) == 2:
            f, expr = p
            if callable(f) and isinstance(expr, str):
                return Adhoc(f, expr)
            raise ValueError(
                'An ad hoc starting probability must be specified as a '
                '(callable, expression) pair.'
            )
        elif isinstance(p, numbers.Number):
            if p > 0:
                return Uniform(p)
            raise ValueError(f'Starting probability {p} < 0.')
        else:
            raise ValueError(f'Unknown starting probability: {p}')

    # ------------------------------------------------------------------
    # solver plumbing
    # ------------------------------------------------------------------

    def __getstate__(self):
        state = self.__dict__.copy()
        state['_fn_cache'] = {}  # jitted closures are not picklable
        state.pop('_factory_cache', None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    def _theta_vector(self):
        """Full linear-scale hyperparameter vector
        [p..., q, node..., edge...]."""
        return np.asarray(
            list(flatten(self.hyperparameters)), dtype=np.float64
        )

    def _core_fn(self, nodal, grad):
        """Build (and cache) the jitted batched solve for given traits.
        Cached globally by kernel structure so that clones and sweeps with
        different theta values share one compiled program."""
        key = (
            bool(nodal), grad if isinstance(grad, str) else bool(grad),
            self.backend.mode,
            _kernel_structure(self.node_kernel),
            _kernel_structure(self.edge_kernel),
            type(self.p).__name__,
        )
        if key in _GLOBAL_FN_CACHE:
            return _GLOBAL_FN_CACHE[key]

        knode = self.node_kernel
        kedge = self.edge_kernel
        p_start = self.p
        n_p = len(list(flatten(self.p.theta)))
        mode = self.backend.mode

        def core(theta, batch1, batch2, idx1, idx2, ftol, p_fixed1,
                 p_fixed2, lmin):
            theta = jnp.asarray(theta, dtype=jnp.float32)

            def g1(tree):
                return jax.tree_util.tree_map(lambda a: a[idx1], tree)

            def g2(tree):
                return jax.tree_util.tree_map(lambda a: a[idx2], tree)

            ops = {
                'node_feats_1': g1(batch1['node_feats']),
                'node_feats_2': g2(batch2['node_feats']),
                'node_mask_1': batch1['node_mask'][idx1],
                'node_mask_2': batch2['node_mask'][idx2],
                'degree_1': batch1['degree'][idx1],
                'degree_2': batch2['degree'][idx2],
                'ftol': ftol,
            }
            if mode == 'dense':
                ops['adj_1'] = batch1['adj'][idx1]
                ops['adj_2'] = batch2['adj'][idx2]
                ops['edge_feats_1'] = g1(batch1['edge_feats'])
                ops['edge_feats_2'] = g2(batch2['edge_feats'])
            else:
                for f in ('esrc', 'edst', 'ew'):
                    ops[f + '_1'] = batch1[f][idx1]
                    ops[f + '_2'] = batch2[f][idx2]
                ops['edge_elist_feats_1'] = g1(batch1['edge_elist_feats'])
                ops['edge_elist_feats_2'] = g2(batch2['edge_elist_feats'])

            n_pad = max(batch1['node_mask'].shape[1],
                        batch2['node_mask'].shape[1])
            maxiter = min(n_pad * n_pad, 10000)

            x, Vx, valid = mlgk_solve(
                theta, ops, knode=knode, kedge=kedge, n_p_theta=n_p,
                lmin=lmin, mode=mode, maxiter=maxiter
            )

            pf1 = p_fixed1[idx1] if p_fixed1 is not None else None
            pf2 = p_fixed2[idx2] if p_fixed2 is not None else None
            p1 = p_start.apply(theta[:n_p], ops['node_mask_1'], pf1)
            p2 = p_start.apply(theta[:n_p], ops['node_mask_2'], pf2)
            R = weight_by_p(x, p1, p2)
            if nodal:
                return R
            else:
                return jnp.sum(R, axis=(1, 2))

        if grad == 'hotspot':
            # gradient of ONE nodal entry per pair (the reference
            # evaluates FD gradients only at MaxiMin hotspots,
            # _backend.cu:190-403): gather the per-pair hotspot before
            # differentiating so the forward tangents never materialize
            # (nor transfer) the [P, n, n, n_theta] nodal jacobian.
            def fn(theta, batch1, batch2, idx1, idx2, gtol,
                   p_fixed1, p_fixed2, h1, h2, lmin):
                def hot(t):
                    R = core(
                        t, batch1, batch2, idx1, idx2, gtol, p_fixed1,
                        p_fixed2, lmin
                    )
                    return R[jnp.arange(R.shape[0]), h1, h2]
                return jax.jacfwd(hot)(theta)
            jitted = jax.jit(fn, static_argnames=('lmin',))
        elif grad:
            # value + jacobian in one pass; forward-mode costs one extra
            # implicit solve per hyperparameter — the exact analogue of the
            # reference's simultaneous dual-RHS solve, but for every theta.
            # The jacobian's solves (linearization point + tangents) run at
            # the gtol tolerance, like the reference's separate gradient CG
            # tolerance (gtol vs ftol in its CUDA backend).
            def fn(theta, batch1, batch2, idx1, idx2, ftol, gtol,
                   p_fixed1, p_fixed2, lmin):
                value = core(
                    theta, batch1, batch2, idx1, idx2, ftol, p_fixed1,
                    p_fixed2, lmin
                )
                jacobian = jax.jacfwd(core)(
                    theta, batch1, batch2, idx1, idx2, gtol, p_fixed1,
                    p_fixed2, lmin
                )
                return value, jacobian
            jitted = jax.jit(fn, static_argnames=('lmin',))
        else:
            jitted = jax.jit(core, static_argnames=('lmin',))

        _GLOBAL_FN_CACHE[key] = jitted
        return jitted

    def _prepare_batch(self, graphs):
        batch = batch_graphs(graphs)
        batch_dict = {
            'node_mask': jnp.asarray(batch.node_mask),
            'degree': jnp.asarray(batch.degree),
            'node_feats': jax.tree_util.tree_map(
                jnp.asarray, batch.node_feats
            ),
        }
        if self.backend.mode == 'dense':
            batch_dict['adj'] = jnp.asarray(batch.adj)
            batch_dict['edge_feats'] = jax.tree_util.tree_map(
                jnp.asarray, batch.edge_feats
            )
        else:
            batch_dict['esrc'] = jnp.asarray(batch.esrc)
            batch_dict['edst'] = jnp.asarray(batch.edst)
            batch_dict['ew'] = jnp.asarray(batch.ew)
            batch_dict['edge_elist_feats'] = jax.tree_util.tree_map(
                jnp.asarray, batch.edge_elist_feats
            )

        p_fixed = None
        if isinstance(self.p, Adhoc):
            n_pad = batch.node_mask.shape[1]
            p_fixed = np.zeros((len(graphs), n_pad), dtype=np.float32)
            for b, g in enumerate(graphs):
                p_values, _ = self.p(g.nodes)
                p_values = np.asarray(p_values, dtype=np.float32)
                # frame rows -> node-index order (matches pack_graph)
                order = np.argsort(np.asarray(g.nodes['!i']))
                p_fixed[b, :len(g.nodes)] = p_values[order]
            p_fixed = jnp.asarray(p_fixed)
        return batch, batch_dict, p_fixed

    def _chunk_size(self, n_pad, m_pad, eval_gradient=False,
                    nodal=False):
        """Job-chunk size bounded by the solver's working-set memory.

        Forward-mode jacobians (``jacfwd``) carry one tangent per
        hyperparameter through the solve, and nodal gradients
        additionally materialize [chunk, n, n, n_theta] outputs — both
        scale the per-pair working set by ~n_theta (ROADMAP: nodal
        protein workloads)."""
        budget = 1 << 26  # floats (~256 MB f32)
        if self.backend.mode == 'dense':
            per_pair = max(n_pad ** 4, 1)
        else:
            per_pair = max(
                m_pad * m_pad + 4 * m_pad * n_pad + 8 * n_pad * n_pad, 1
            )
        if eval_gradient:
            n_theta = max(int(self.n_dims), 1)
            per_pair *= 1 + n_theta
            if nodal:
                per_pair += n_pad * n_pad * n_theta
        return int(np.clip(budget // per_pair, 1, 4096))

    def _run_chunks(self, fn, theta, bd1, bd2, pf1, pf2, i_jobs,
                    j_jobs, chunk, lmin, eval_gradient):
        """Run the jitted solve over fixed-size job chunks; returns
        concatenated numpy outputs (and gradients)."""
        ftol = np.float32(self.ftol)
        gtol = np.float32(self.gtol)
        P = len(i_jobs)
        outs, grads = [], []
        for s in range(0, P, chunk):
            idx1 = np.asarray(i_jobs[s:s + chunk], dtype=np.int32)
            idx2 = np.asarray(j_jobs[s:s + chunk], dtype=np.int32)
            pad = chunk - len(idx1) if P > chunk else 0
            if pad > 0:
                idx1 = np.pad(idx1, (0, pad))
                idx2 = np.pad(idx2, (0, pad))
            if eval_gradient:
                res = fn(theta, bd1, bd2, jnp.asarray(idx1),
                         jnp.asarray(idx2), ftol, gtol, pf1, pf2,
                         lmin=lmin)
            else:
                res = fn(theta, bd1, bd2, jnp.asarray(idx1),
                         jnp.asarray(idx2), ftol, pf1, pf2, lmin=lmin)
            if eval_gradient:
                val, jacs = res
                val = np.asarray(val)
                jacs = np.asarray(jacs)
                if pad > 0:
                    val = val[:len(val) - pad]
                    jacs = jacs[:len(jacs) - pad]
                outs.append(val)
                grads.append(jacs)
            else:
                val = np.asarray(res)
                if pad > 0:
                    val = val[:len(val) - pad]
                outs.append(val)
        out = np.concatenate(outs, axis=0)
        if eval_gradient:
            return out, np.concatenate(grads, axis=0)
        return out, None

    def _run_chunks_hotspot(self, fn, theta, bd1, bd2, pf1, pf2,
                            i_jobs, j_jobs, h1, h2, chunk, lmin):
        """Run the hotspot-gradient solve over fixed-size job chunks;
        returns [P, n_theta] numpy gradients."""
        gtol = np.float32(self.gtol)
        P = len(i_jobs)
        grads = []
        for s in range(0, P, chunk):
            sl = slice(s, s + chunk)
            idx1 = np.asarray(i_jobs[sl], dtype=np.int32)
            idx2 = np.asarray(j_jobs[sl], dtype=np.int32)
            hc1 = np.asarray(h1[sl], dtype=np.int32)
            hc2 = np.asarray(h2[sl], dtype=np.int32)
            pad = chunk - len(idx1) if P > chunk else 0
            if pad > 0:
                idx1, idx2, hc1, hc2 = (
                    np.pad(a, (0, pad)) for a in (idx1, idx2, hc1, hc2))
            jac = np.asarray(fn(
                theta, bd1, bd2, jnp.asarray(idx1), jnp.asarray(idx2),
                gtol, pf1, pf2, jnp.asarray(hc1), jnp.asarray(hc2),
                lmin=lmin
            ))
            if pad > 0:
                jac = jac[:len(jac) - pad]
            grads.append(jac)
        return np.concatenate(grads, axis=0)

    def _size_classes(self, graphs, align=8):
        """Partition graph indices into padded-size classes."""
        classes = {}
        for gi, g in enumerate(graphs):
            n_pad = max(align, -(-len(g.nodes) // align) * align)
            classes.setdefault(n_pad, []).append(gi)
        return classes

    def _solve_hotspot_grads(self, graphs, i_jobs, j_jobs, h1, h2,
                             lmin):
        """Per-job hyperparameter gradients of one nodal entry
        (``R[p, h1_p, h2_p]``) each — [P, n_theta] numpy. Used by the
        MaxiMin hotspot gradient; follows the same size-class bucketing
        as :meth:`_solve_jobs`."""
        fn = self._core_fn(nodal=True, grad='hotspot')
        theta = self._theta_vector()
        i_jobs = np.asarray(i_jobs, dtype=np.int64)
        j_jobs = np.asarray(j_jobs, dtype=np.int64)
        h1 = np.asarray(h1, dtype=np.int64)
        h2 = np.asarray(h2, dtype=np.int64)

        classes = self._size_classes(graphs) if self.buckets else None
        if not classes or len(classes) <= 1:
            batch, batch_dict, p_fixed = self._prepare_batch(graphs)
            chunk = self._chunk_size(
                batch.node_mask.shape[1], batch.esrc.shape[1],
                eval_gradient=True, nodal=False)
            return self._run_chunks_hotspot(
                fn, theta, batch_dict, batch_dict, p_fixed, p_fixed,
                i_jobs, j_jobs, h1, h2, chunk, lmin)

        class_of = np.empty(len(graphs), dtype=np.int64)
        local_of = np.empty(len(graphs), dtype=np.int64)
        batches = {}
        for ck, members in classes.items():
            for li, gi in enumerate(members):
                class_of[gi] = ck
                local_of[gi] = li
            batches[ck] = self._prepare_batch(
                [graphs[gi] for gi in members])

        groups = {}
        for p, (gi, gj) in enumerate(zip(i_jobs, j_jobs)):
            ca, cb = class_of[gi], class_of[gj]
            swap = ca > cb
            key = (min(ca, cb), max(ca, cb))
            a, b = (gj, gi) if swap else (gi, gj)
            # a swapped job computes R[gj, gi]: its hotspot transposes
            ha, hb = (h2[p], h1[p]) if swap else (h1[p], h2[p])
            groups.setdefault(key, []).append(
                (p, local_of[a], local_of[b], ha, hb))

        grad = np.empty((len(i_jobs), len(theta)))
        for (ca, cb), entries in groups.items():
            _, bd1, pf1 = batches[ca]
            batch_b, bd2, pf2 = batches[cb]
            m_pad = max(
                batches[ca][0].esrc.shape[1], batch_b.esrc.shape[1])
            chunk = self._chunk_size(
                cb, m_pad, eval_gradient=True, nodal=False)
            ps, l1, l2, ha, hb = map(np.asarray, zip(*entries))
            grad[ps] = self._run_chunks_hotspot(
                fn, theta, bd1, bd2, pf1, pf2, l1, l2, ha, hb, chunk,
                lmin)
        return grad

    def _solve_jobs(self, graphs, i_jobs, j_jobs, nodal, lmin,
                    eval_gradient, timer=None):
        """Solve all (i, j) jobs; returns [P(,n1,n2)] numpy arrays (+ the
        full-dimensional gradient when requested). With ``buckets`` on and
        heterogeneous sizes, jobs are grouped into per-size-class batches
        so small pairs are not padded to the global maximum (the static
        analogue of the reference's per-pair dynamic blocks)."""
        fn = self._core_fn(nodal=nodal, grad=eval_gradient)
        theta = self._theta_vector()
        i_jobs = np.asarray(i_jobs, dtype=np.int64)
        j_jobs = np.asarray(j_jobs, dtype=np.int64)

        classes = self._size_classes(graphs) if self.buckets else None
        if not classes or len(classes) <= 1:
            batch, batch_dict, p_fixed = self._prepare_batch(graphs)
            n_pad = batch.node_mask.shape[1]
            m_pad = batch.esrc.shape[1]
            chunk = self._chunk_size(
                n_pad, m_pad, eval_gradient=eval_gradient, nodal=nodal)
            out, grad_out = self._run_chunks(
                fn, theta, batch_dict, batch_dict, p_fixed, p_fixed,
                i_jobs, j_jobs, chunk, lmin, eval_gradient
            )
            return (out, grad_out) if eval_gradient else out

        # ---- bucketed path ----
        class_of = np.empty(len(graphs), dtype=np.int64)
        local_of = np.empty(len(graphs), dtype=np.int64)
        keys = sorted(classes)
        batches = {}
        for ck, members in classes.items():
            for li, gi in enumerate(members):
                class_of[gi] = ck
                local_of[gi] = li
            batches[ck] = self._prepare_batch(
                [graphs[gi] for gi in members]
            )

        # group jobs by (class_a <= class_b); remember transposes
        groups = {}
        for p, (gi, gj) in enumerate(zip(i_jobs, j_jobs)):
            ca, cb = class_of[gi], class_of[gj]
            swap = ca > cb
            key = (min(ca, cb), max(ca, cb))
            a, b = (gj, gi) if swap else (gi, gj)
            groups.setdefault(key, []).append(
                (p, local_of[a], local_of[b], swap)
            )

        raw = [None] * len(i_jobs)
        raw_grad = [None] * len(i_jobs) if eval_gradient else None
        for (ca, cb), entries in groups.items():
            _, bd1, pf1 = batches[ca]
            batch_b, bd2, pf2 = batches[cb]
            m_pad = max(
                batches[ca][0].esrc.shape[1], batch_b.esrc.shape[1]
            )
            chunk = self._chunk_size(
                cb, m_pad, eval_gradient=eval_gradient, nodal=nodal)
            ps, l1, l2, swaps = map(np.asarray, zip(*entries))
            out, grad_out = self._run_chunks(
                fn, theta, bd1, bd2, pf1, pf2, l1, l2, chunk, lmin,
                eval_gradient
            )
            for k, p in enumerate(ps):
                o = out[k]
                g = grad_out[k] if eval_gradient else None
                if swaps[k] and nodal:
                    o = np.swapaxes(o, 0, 1)
                    if g is not None:
                        g = np.swapaxes(g, 0, 1)
                raw[p] = o
                if eval_gradient:
                    raw_grad[p] = g
        if eval_gradient:
            return raw, raw_grad
        return raw

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    # union-packed API path: large non-nodal calls route
    # through the GramFactory grouped/union machinery so the documented
    # sklearn surface (and hence GPR predict, the examples) gets the
    # flagship throughput. The reference likewise has ONE hot path for
    # both surfaces (graphdot/kernel/marginalized/_kernel.py:114 ->
    # _backend_cuda.py:247).
    # ------------------------------------------------------------------

    #: minimum job count before a __call__ routes through a factory
    #: (small calls stay on the globally-cached per-pair programs;
    #: each factory jits its own program, which only amortizes at
    #: Gram-sized job lists). GRAPHDOT_API_UNION=0 disables routing,
    #: =1 forces it for any size, an int sets the threshold.
    _API_UNION_MIN_JOBS = 512

    def _get_call_factory(self, X, Y):
        """A cached (factory, jitted-fns) pair for the graph lists.
        Entries are invalidated when any graph mutates (its cookie is
        cleared on permute/unify) and kept in a 4-entry LRU."""
        from ...inference.gram import GramFactory

        cache = self.__dict__.setdefault('_factory_cache', {})
        key = (tuple(map(id, X)),
               None if Y is None else tuple(map(id, Y)),
               self.backend.mode)
        all_graphs = list(X) + (list(Y) if Y is not None else [])
        ent = cache.get(key)
        if ent is not None:
            fac, fns, token = ent
            if all(g.cookie.get(('apifac', key)) is token
                   for g in all_graphs):
                return fac, fns
            del cache[key]
        pred_or_tuple = Graph.has_unified_types(all_graphs)
        if pred_or_tuple is not True:
            group, first, second = pred_or_tuple
            raise TypeError(
                f'The two graphs have mismatching {group} attributes '
                'or attribute types. Try `Graph.unify_datatype`.\n'
                f'First graph: {first}\nSecond graph: {second}\n')
        fac = GramFactory(
            self, list(X), normalize=False,
            graphs2=None if Y is None else list(Y))
        fns = {}
        token = object()
        for g in all_graphs:
            g.cookie[('apifac', key)] = token
        cache[key] = (fac, fns, token)
        while len(cache) > 4:
            del cache[next(iter(cache))]
        return fac, fns

    def _factory_call(self, X, Y, eval_gradient, lmin):
        """Solve a non-nodal __call__ through the union-packed factory
        path. Returns (K, dK-or-None) as numpy, or None to decline
        (small job lists, unsupported backend mode)."""
        import os
        env = os.environ.get('GRAPHDOT_API_UNION', 'auto')
        v = env.strip().lower()
        if v in ('0', 'false', 'off', 'no'):
            return None
        if v in ('auto', ''):
            min_jobs = self._API_UNION_MIN_JOBS
        elif v in ('1', 'true', 'on', 'yes'):
            min_jobs = 0
        else:
            min_jobs = int(v)
        if self.backend.mode not in ('pallas', 'edge'):
            return None
        nX = len(X)
        nY = nX if Y is None else len(Y)
        n_jobs = nX * (nX + 1) // 2 if Y is None else nX * nY
        if n_jobs < min_jobs:
            return None

        fac, fns = self._get_call_factory(X, Y)
        fkey = (int(lmin), bool(eval_gradient))
        if fkey not in fns:
            if eval_gradient:
                def vj(t, _l=int(lmin)):
                    f = lambda tt: fac.gram(tt, lmin=_l)  # noqa: E731
                    return f(t), jax.jacfwd(f)(t)
                fns[fkey] = jax.jit(vj)
            else:
                fns[fkey] = jax.jit(
                    lambda t, _l=int(lmin): fac.gram(t, lmin=_l))

        active = np.asarray(self.active_theta_mask)
        th_lin = np.asarray(self.flat_hyperparameters,
                            dtype=np.float64)[active]
        # memoize the device-resident theta: repeated calls at the same
        # hyperparameters (predict loops) skip the host->device transfer
        memo = fns.setdefault('_theta_memo', {})
        tkey = th_lin.tobytes()
        t = memo.get(tkey)
        if t is None:
            memo.clear()
            t = jnp.asarray(np.log(th_lin), dtype=jnp.float32)
            memo[tkey] = t
        if eval_gradient:
            K, jac = fns[fkey](t)
            # jacfwd is w.r.t. log-theta; __call__'s contract is
            # d K / d theta on the linear scale
            dK = np.asarray(jac) / th_lin[None, None, :]
            return np.asarray(K), dK
        return np.asarray(fns[fkey](t)), None

    def __call__(self, X, Y=None, eval_gradient=False, nodal=False, lmin=0,
                 timing=False):
        """Compute the pairwise similarity matrix between graphs.

        Parameters
        ----------
        X: list of N graphs (must have identical feature signatures)
        Y: None or list of M graphs
        eval_gradient: if True, also return d K / d theta (linear scale,
            active hyperparameters only).
        nodal: if True, return node-wise similarities.
        lmin: 0 or 1 — number of steps to skip in each random walk path.

        Returns
        -------
        kernel_matrix: ndarray; plus gradient ndarray if eval_gradient.
        """
        timer = Timer()
        if not nodal:
            # attempted BEFORE the type check: a factory cache hit
            # proves the graphs were unified when the factory was
            # built and have not mutated since (cookie tokens); a miss
            # runs the check inside _get_call_factory
            timer.tic('union-packed factory path')
            routed = self._factory_call(X, Y, eval_gradient, lmin)
            timer.toc('union-packed factory path')
            if routed is not None:
                K, dK = routed
                if timing:
                    timer.report(unit='ms')
                timer.reset()
                if eval_gradient:
                    return (K.astype(self.element_dtype),
                            dK.astype(self.element_dtype))
                return K.astype(self.element_dtype)

        all_graphs = list(X) + (list(Y) if Y is not None else [])
        pred_or_tuple = Graph.has_unified_types(all_graphs)
        if pred_or_tuple is not True:
            group, first, second = pred_or_tuple
            raise TypeError(
                f'The two graphs have mismatching {group} attributes or '
                'attribute types. If the attributes match in name but '
                'differ in type, try `Graph.unify_datatype` as an '
                'automatic fix.\n'
                f'First graph: {first}\n'
                f'Second graph: {second}\n'
            )

        timer.tic('generating jobs')
        symmetric = Y is None
        if symmetric:
            i, j = np.triu_indices(len(X))
        else:
            i, j = np.indices((len(X), len(Y)))
            j = j + len(X)
        i = i.ravel()
        j = j.ravel()
        timer.toc('generating jobs')

        timer.tic('solving pair jobs')
        result = self._solve_jobs(
            all_graphs, i, j, nodal=bool(nodal), lmin=lmin,
            eval_gradient=eval_gradient
        )
        timer.toc('solving pair jobs')

        timer.tic('collecting result')
        sizes = np.array([len(g.nodes) for g in all_graphs])
        if eval_gradient:
            raw, raw_grad = result
        else:
            raw, raw_grad = result, None

        gramian, gradient = self._assemble(
            raw, raw_grad, i, j, sizes, len(X),
            len(Y) if Y is not None else None, nodal
        )
        timer.toc('collecting result')

        if timing:
            timer.report(unit='ms')
        timer.reset()

        if eval_gradient:
            return (
                gramian.astype(self.element_dtype),
                gradient[:, :, self.active_theta_mask].astype(
                    self.element_dtype
                )
            )
        else:
            return gramian.astype(self.element_dtype)

    def _assemble(self, raw, raw_grad, i_jobs, j_jobs, sizes, nX, nY,
                  nodal):
        """Scatter per-pair results into the output matrix layout
        (reference ``_kernel.py:185-264``)."""
        symmetric = nY is None
        n_dims = self.n_dims
        if nodal:
            starts = np.concatenate([[0], np.cumsum(sizes)])
            if symmetric:
                rows = cols = starts[nX]
                col_base = starts
            else:
                rows = starts[nX]
                cols = starts[len(sizes)] - starts[nX]
                col_base = starts - starts[nX]
            R = np.zeros((rows, cols))
            dR = np.zeros((rows, cols, n_dims)) if raw_grad is not None \
                else None
            for p, (gi, gj) in enumerate(zip(i_jobs, j_jobs)):
                ni, nj = sizes[gi], sizes[gj]
                r0, c0 = starts[gi], col_base[gj]
                R[r0:r0 + ni, c0:c0 + nj] = raw[p][:ni, :nj]
                if dR is not None:
                    dR[r0:r0 + ni, c0:c0 + nj] = raw_grad[p][:ni, :nj]
                if symmetric and gi != gj:
                    R[c0:c0 + nj, r0:r0 + ni] = raw[p][:ni, :nj].T
                    if dR is not None:
                        dR[c0:c0 + nj, r0:r0 + ni] = np.swapaxes(
                            raw_grad[p][:ni, :nj], 0, 1
                        )
            return R, dR
        else:
            if symmetric:
                R = np.zeros((nX, nX))
                dR = np.zeros((nX, nX, n_dims)) if raw_grad is not None \
                    else None
                for p, (gi, gj) in enumerate(zip(i_jobs, j_jobs)):
                    R[gi, gj] = raw[p]
                    R[gj, gi] = raw[p]
                    if dR is not None:
                        dR[gi, gj] = raw_grad[p]
                        dR[gj, gi] = raw_grad[p]
            else:
                R = np.zeros((nX, nY))
                dR = np.zeros((nX, nY, n_dims)) if raw_grad is not None \
                    else None
                for p, (gi, gj) in enumerate(zip(i_jobs, j_jobs)):
                    R[gi, gj - nX] = raw[p]
                    if dR is not None:
                        dR[gi, gj - nX] = raw_grad[p]
            return R, dR

    def diag(self, X, eval_gradient=False, nodal=False, lmin=0,
             active_theta_only=True, timing=False):
        """Compute the self-similarities of a list of graphs.

        nodal=False -> [N] graph self-similarities; nodal=True -> vector of
        nodal self-similarities; nodal='block' -> list of per-graph nodal
        similarity matrices.
        """
        timer = Timer()
        pred_or_tuple = Graph.has_unified_types(X)
        if pred_or_tuple is not True:
            group, first, second = pred_or_tuple
            raise TypeError(
                f'The two graphs have mismatching {group} attributes or '
                'attribute types. Try `Graph.unify_datatype`.\n'
                f'First graph: {first}\nSecond graph: {second}\n'
            )

        i = np.arange(len(X))
        need_nodal = bool(nodal)  # True for both True and 'block'

        timer.tic('solving pair jobs')
        result = self._solve_jobs(
            list(X), i, i, nodal=need_nodal, lmin=lmin,
            eval_gradient=eval_gradient
        )
        timer.toc('solving pair jobs')

        if eval_gradient:
            raw, raw_grad = result
        else:
            raw, raw_grad = result, None

        sizes = np.array([len(g.nodes) for g in X])
        if nodal is True:
            out = np.concatenate([
                np.diagonal(raw[p][:n, :n]) for p, n in enumerate(sizes)
            ])
            if raw_grad is not None:
                grad = np.concatenate([
                    np.diagonal(raw_grad[p][:n, :n], axis1=0,
                                axis2=1).T
                    for p, n in enumerate(sizes)
                ])
        elif nodal is False:
            out = raw
            grad = raw_grad
        elif nodal == 'block':
            out = [raw[p][:n, :n] for p, n in enumerate(sizes)]
            if raw_grad is not None:
                grad = [raw_grad[p][:n, :n] for p, n in enumerate(sizes)]
        else:
            raise ValueError("Invalid 'nodal' option '%s'" % nodal)

        if timing:
            timer.report(unit='ms')
        timer.reset()

        if eval_gradient:
            if active_theta_only and nodal != 'block':
                grad = np.asarray(grad)[..., self.active_theta_mask]
            if nodal == 'block':
                return (
                    out,
                    [g.astype(self.element_dtype) for g in grad]
                )
            return (
                np.asarray(out).astype(self.element_dtype),
                np.asarray(grad).astype(self.element_dtype)
            )
        else:
            if nodal == 'block':
                return out
            return np.asarray(out).astype(self.element_dtype)

    # ------------------------------------------------------------------
    # scikit-learn interoperability (reference ``_kernel.py:410-508``)
    # ------------------------------------------------------------------

    def is_stationary(self):
        return False

    @property
    def requires_vector_input(self):
        return False

    @property
    def hyperparameters(self):
        """A hierarchical representation of all kernel hyperparameters."""
        return pretty_tuple(
            'MarginalizedGraphKernel',
            ['starting_probability', 'stopping_probability', 'node_kernel',
             'edge_kernel']
        )(self.p.theta, self.q, self.node_kernel.theta,
          self.edge_kernel.theta)

    @property
    def flat_hyperparameters(self):
        return np.fromiter(flatten(self.hyperparameters), float)

    @property
    def hyperparameter_bounds(self):
        return pretty_tuple(
            'GraphKernelHyperparameterBounds',
            ['starting_probability', 'stopping_probability', 'node_kernel',
             'edge_kernel']
        )(self.p.bounds, self.q_bounds, self.node_kernel.bounds,
          self.edge_kernel.bounds)

    @property
    def n_dims(self):
        """Number of hyperparameters, optimizable and fixed alike."""
        return len(self.flat_hyperparameters)

    def _bounds_table(self):
        """[n_dims, 2] linear-scale bounds table, one row per
        hyperparameter in theta order; ``'fixed'`` entries become NaN
        rows.

        ``flatten`` splits each (lo, hi) pair into two consecutive
        scalars but yields the 'fixed' sentinel (a string) and any
        2-array bound whole, so the walk consumes one or two stream items
        per hyperparameter accordingly.
        """
        rows = []
        stream = flatten(self.hyperparameter_bounds)
        for item in stream:
            if isinstance(item, str):
                if item != 'fixed':
                    raise ValueError(f'Unknown bound spec {item!r}')
                rows.append((np.nan, np.nan))
            elif hasattr(item, '__len__'):
                lo, hi = item
                rows.append((float(lo), float(hi)))
            else:
                rows.append((float(item), float(next(stream))))
        return np.asarray(rows, dtype=float).reshape(-1, 2)

    @property
    def active_theta_mask(self):
        """Boolean mask over the full hyperparameter vector: True for
        entries that participate in optimization, False for 'fixed' ones
        and degenerate lo == hi bounds."""
        table = self._bounds_table()
        fixed = np.isnan(table).any(axis=1)
        degenerate = table[:, 0] == table[:, 1]
        return ~(fixed | degenerate)

    @property
    def theta(self):
        """Log-scale flattened vector of the active hyperparameters."""
        return np.log(self.flat_hyperparameters[self.active_theta_mask])

    @theta.setter
    def theta(self, value):
        full = self.flat_hyperparameters
        full[self.active_theta_mask] = np.exp(value)
        (self.p.theta,
         self.q,
         self.node_kernel.theta,
         self.edge_kernel.theta
         ) = fold_like(full, self.hyperparameters)

    @property
    def bounds(self):
        """Log-scale n-by-2 array of active hyperparameter bounds."""
        return np.log(self._bounds_table()[self.active_theta_mask])

    def clone_with_theta(self, theta=None):
        clone = copy.deepcopy(self)
        clone._fn_cache = self._fn_cache  # jitted fns are theta-independent
        # factories embed only FIXED hyperparameters; active theta is a
        # traced argument, so clones can share them too
        clone._factory_cache = getattr(self, '_factory_cache', None) \
            or clone.__dict__.setdefault('_factory_cache', {})
        if theta is not None:
            clone.theta = theta
        return clone
