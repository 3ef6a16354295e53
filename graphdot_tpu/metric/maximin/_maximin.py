"""MaxiMin (Hausdorff-like) graph distance (reference:
``graphdot/metric/maximin/_maximin.py:11`` + ``_backend.cu:40-408``).

The reference needs a dedicated 408-line CUDA kernel because its solver
only materializes what each thread block computes; here the batched solver
already returns full nodal similarity matrices per pair, so the maximin
reduction (kernel-induced distance -> row/col min -> max), the hotspot
tie-breaking, and the hotspot-restricted gradient are *batched masked
reductions* over all pairs of a padded-shape group at once — no per-pair
Python loop (round-3 rewrite of the round-2 host loop).
"""
import numpy as np

from ...graph import Graph
from ...kernel.marginalized import MarginalizedGraphKernel
from ...util import Timer


class MaxiMin(MarginalizedGraphKernel):
    """The maximin graph distance: the greatest of all kernel-induced
    distances from a node in one graph to the closest node in the other
    graph, using the marginalized graph kernel as the nodal similarity.

    Accepts the same arguments as MarginalizedGraphKernel.
    """

    #: nudge applied to 1/d in gradient computations for stability near 0
    #: (the reference's ``num_hacks``, ``_backend.cu:29-36``)
    _grad_eps = 1e-4

    def __init__(self, *args, **kwargs):
        kwargs['dtype'] = np.float32
        super().__init__(*args, **kwargs)

    @staticmethod
    def _induced_distance(k12, k1, k2):
        """d = sqrt(max(0, 1 - k12 / sqrt(k1 k2)))."""
        return np.sqrt(
            np.maximum(0.0, 1.0 - k12 / np.sqrt(k1 * k2))
        )

    def _reduce_block(self, ks, k1, k2, n1, n2):
        """Batched maximin reduction over a stacked block of pairs.

        Parameters: ks (P, a, b) nodal cross similarities; k1 (P, a) and
        k2 (P, b) padded self similarities; n1, n2 (P,) valid node counts.
        Returns (dh, i1, i2): the maximin distance and its hotspot node
        pair per stacked pair, tie-broken to the largest flat index like
        the reference's atomicMax.
        """
        P, a, b = ks.shape
        rows = np.arange(a)[None, :] < n1[:, None]
        cols = np.arange(b)[None, :] < n2[:, None]
        valid = rows[:, :, None] & cols[:, None, :]

        D = self._induced_distance(ks, k1[:, :, None], k2[:, None, :])
        D_masked = np.where(valid, D, np.inf)
        to_rows = np.where(rows, D_masked.min(axis=2), -np.inf).max(axis=1)
        to_cols = np.where(cols, D_masked.min(axis=1), -np.inf).max(axis=1)
        dh = np.maximum(to_rows, to_cols)

        flat = (
            np.arange(a)[None, :, None] * n2[:, None, None]
            + np.arange(b)[None, None, :]
        )
        at_max = (D == dh[:, None, None]) & valid
        hot = np.where(at_max, flat, -1).reshape(P, -1).max(axis=1)
        hot = np.maximum(hot, 0)
        return dh, hot // n2, hot % n2

    def _hotspot_gradient(self, k12h, dk12h, k1h, k2h, dk1h, dk2h, dh):
        """Analytic gradient of the maximin distance from flat per-job
        hotspot quantities (the reference evaluates FD gradients at the
        hotspots, ``_backend.cu:190-403``; here the hotspot entry's
        exact gradient comes from one gathered-jacfwd solve pass)."""
        geo = np.sqrt(k1h * k2h)
        d_ratio = (
            dk12h / geo[:, None]
            - (0.5 * k12h / geo ** 3)[:, None]
            * (dk1h * k2h[:, None] + k1h[:, None] * dk2h)
        )
        return -d_ratio * (0.5 / (dh + self._grad_eps))[:, None]

    def device_distance_fn(self, X, lmin=0):
        """Fully on-device distance-matrix function over a fixed graph
        set.

        Returns ``(fn, theta0)``: ``fn(theta_log_active) -> [n, n]``
        maximin distance matrix computed inside ONE jitted program —
        all nodal pair solves at a single padded shape plus the masked
        maximin reduction — and ``theta0``, the current log-scale
        active hyperparameter vector.

        This is the device core of :meth:`__call__` (which additionally
        returns hotspots/gradients, handles rectangular X/Y, and
        reduces per size-class on the host). Because it is a pure
        traced function of theta it can be jitted whole, which is what
        ``bench_maximin.py`` times, and it composes with
        ``jax.grad``-based inference loops.
        """
        import jax
        import jax.numpy as jnp
        from ...inference.gram import GramFactory
        from ...kernel.marginalized._solver import mlgk_solve, \
            weight_by_p

        fac = GramFactory(self, list(X), normalize=False,
                          buckets=False, union=False)
        n = fac._n
        iu, ju = fac._iu, fac._ju          # includes the diagonal jobs
        iu_h, ju_h = np.asarray(iu), np.asarray(ju)
        diag_pos = jnp.asarray(
            np.flatnonzero(iu_h == ju_h).astype(np.int32))
        node_mask = fac._batch['node_mask']
        pf = fac._p_fixed
        n_p = fac._n_p
        maxiter = min(fac._n_pad ** 2, fac._maxiter_cap)

        def fn(theta_log_active):
            theta = fac.full_theta(theta_log_active)
            ops = fac._group_ops(
                fac._batch, fac._batch, iu, ju, fac._onehots)
            x, _, _ = mlgk_solve(
                theta, ops, knode=self.node_kernel,
                kedge=self.edge_kernel, n_p_theta=n_p, lmin=lmin,
                mode=fac._mode, maxiter=maxiter)
            p1 = self.p.apply(
                theta[:n_p], ops['node_mask_1'],
                pf[iu] if pf is not None else None)
            p2 = self.p.apply(
                theta[:n_p], ops['node_mask_2'],
                pf[ju] if pf is not None else None)
            R = weight_by_p(x, p1, p2)                   # [P, a, a]
            k_self = jnp.diagonal(
                R[diag_pos], axis1=1, axis2=2)           # [n, a]
            k1 = k_self[iu]
            k2 = k_self[ju]
            rows = node_mask[iu] > 0
            cols = node_mask[ju] > 0
            valid = rows[:, :, None] & cols[:, None, :]
            ratio = R * jax.lax.rsqrt(
                k1[:, :, None] * k2[:, None, :] + 1e-30)
            D = jnp.sqrt(jnp.maximum(0.0, 1.0 - ratio))
            Dm = jnp.where(valid, D, jnp.inf)
            to_rows = jnp.where(
                rows, Dm.min(axis=2), -jnp.inf).max(axis=1)
            to_cols = jnp.where(
                cols, Dm.min(axis=1), -jnp.inf).max(axis=1)
            dh = jnp.maximum(to_rows, to_cols)
            return (jnp.zeros((n, n), jnp.float32)
                    .at[iu, ju].set(dh).at[ju, iu].set(dh))

        return jax.jit(fn), jnp.asarray(fac.theta0, dtype=jnp.float32)

    def __call__(self, X, Y=None, eval_gradient=False, lmin=0,
                 return_hotspot=False, timing=False):
        """Computes the distance matrix, optionally the hotspot node-pair
        indices and the gradient w.r.t. hyperparameters.

        Returns
        -------
        distance: [len(X), len(Y or X)] matrix
        hotspot: (i1, i2) pair of index matrices (if return_hotspot)
        gradient: [.., .., n_active] tensor (if eval_gradient)
        """
        timer = Timer()
        all_graphs = list(X) + (list(Y) if Y is not None else [])
        pred_or_tuple = Graph.has_unified_types(all_graphs)
        if pred_or_tuple is not True:
            group, first, second = pred_or_tuple
            raise TypeError(
                f'The two graphs have mismatching {group} attributes or '
                'attribute types. Try `Graph.unify_datatype`.\n'
                f'First graph: {first}\nSecond graph: {second}\n'
            )

        symmetric = Y is None
        nX = len(X)
        nY = len(Y) if Y is not None else nX
        sizes = np.array([len(g.nodes) for g in all_graphs])
        starts = np.concatenate([[0], np.cumsum(sizes)])
        n_max = sizes.max()

        timer.tic('nodal self similarities')
        diag = self.diag(
            all_graphs, eval_gradient, nodal=True, lmin=lmin,
            active_theta_only=False
        )
        if eval_gradient:
            diag, ddiag = diag
        # per-graph padded views of the ragged nodal self-similarities
        # (pad with ones so the masked-out induced distances stay finite)
        k_self = np.ones((len(all_graphs), n_max))
        for g, (lo, n) in enumerate(zip(starts, sizes)):
            k_self[g, :n] = diag[lo:lo + n]
        if eval_gradient:
            dk_self = np.zeros((len(all_graphs), n_max, ddiag.shape[-1]))
            for g, (lo, n) in enumerate(zip(starts, sizes)):
                dk_self[g, :n] = ddiag[lo:lo + n]
        timer.toc('nodal self similarities')

        timer.tic('nodal cross similarities')
        if symmetric:
            i_jobs, j_jobs = np.triu_indices(nX)
        else:
            i_jobs, j_jobs = np.indices((nX, nY))
            j_jobs = j_jobs + nX
        i_jobs, j_jobs = i_jobs.ravel(), j_jobs.ravel()
        # values only — gradients are evaluated afterwards at the
        # hotspots alone, so the full nodal jacobian is never built
        raw = self._solve_jobs(
            all_graphs, i_jobs, j_jobs, nodal=True, lmin=lmin,
            eval_gradient=False
        )
        timer.toc('nodal cross similarities')

        timer.tic('maximin reduction')
        P = len(i_jobs)
        distance = np.zeros((nX, nY), dtype=np.float64)
        hotspot = np.full((nX, nY), -1, dtype=np.int64)
        dh_all = np.zeros(P)
        hot1 = np.zeros(P, dtype=np.int64)
        hot2 = np.zeros(P, dtype=np.int64)
        k12h = np.zeros(P)
        k1h = np.ones(P)
        k2h = np.ones(P)

        # group jobs by padded block shape, reduce each group at once
        by_shape = {}
        for p in range(P):
            by_shape.setdefault(raw[p].shape, []).append(p)

        def fit_width(M, width, fill):
            """Crop or pad the trailing node axis of a padded view."""
            if M.shape[1] >= width:
                return M[:, :width]
            out = np.full((len(M), width) + M.shape[2:], fill, M.dtype)
            out[:, :M.shape[1]] = M
            return out

        for shape, ps in by_shape.items():
            ps = np.asarray(ps)
            gi, gj = i_jobs[ps], j_jobs[ps]
            n1, n2 = sizes[gi], sizes[gj]
            ks = np.stack([np.asarray(raw[p], dtype=np.float64)
                           for p in ps])
            a, b = shape[:2]
            k1 = fit_width(k_self[gi], a, 1.0)
            k2 = fit_width(k_self[gj], b, 1.0)
            dh, i1, i2 = self._reduce_block(ks, k1, k2, n1, n2)

            col = gj - nX if not symmetric else gj
            distance[gi, col] = dh
            hotspot[gi, col] = i1 * n2 + i2
            rows = np.arange(len(ps))
            dh_all[ps] = dh
            hot1[ps], hot2[ps] = i1, i2
            k12h[ps] = ks[rows, i1, i2]
            k1h[ps], k2h[ps] = k1[rows, i1], k2[rows, i2]
            if symmetric:
                off = gi != gj
                distance[gj[off], gi[off]] = dh[off]
                hotspot[gj[off], gi[off]] = (i2 * n1 + i1)[off]
        timer.toc('maximin reduction')

        gradient = None
        if eval_gradient:
            timer.tic('hotspot gradients')
            dk12 = self._solve_hotspot_grads(
                all_graphs, i_jobs, j_jobs, hot1, hot2, lmin)
            grad_rows = self._hotspot_gradient(
                k12h, dk12, k1h, k2h,
                dk_self[i_jobs, hot1], dk_self[j_jobs, hot2], dh_all)
            gradient = np.zeros((nX, nY, self.n_dims))
            col = j_jobs - nX if not symmetric else j_jobs
            gradient[i_jobs, col] = grad_rows
            if symmetric:
                off = i_jobs != j_jobs
                gradient[j_jobs[off], i_jobs[off]] = grad_rows[off]
            timer.toc('hotspot gradients')

        if timing:
            timer.report(unit='ms')
        timer.reset()

        retval = [distance.astype(self.element_dtype)]
        if return_hotspot is True:
            n = np.array(
                [len(g.nodes) for g in (Y if Y is not None else X)]
            )
            retval.append((hotspot // n, hotspot % n))
        if eval_gradient is True:
            retval.append(
                gradient[:, :, self.active_theta_mask].astype(
                    self.element_dtype
                )
            )
        if len(retval) == 1:
            return retval[0]
        return tuple(retval)
