"""Differentiable Gram-matrix construction for Bayesian inference.

Builds a pure JAX function ``theta_log_active -> K`` over a fixed set of
graphs, so that GP log-probabilities (and hence NUTS/HMC/SMC/VI over kernel
hyperparameters) can be traced, jitted, sharded, and differentiated
end-to-end. This is the inference-facing counterpart of
``MarginalizedGraphKernel.__call__`` (which returns numpy and targets the
sklearn-style API).

Size bucketing (``buckets='auto'``, the default): graphs are partitioned
into padded-size classes and each class-pair group is solved at its own
static shapes inside the same traced function, so small graph pairs are
not padded to the global maximum — the static analogue of the reference's
per-pair dynamic CUDA blocks (``graphdot/kernel/marginalized/template.cu``
job loop). Each group gets its own convergence loop, so quickly-converging
small pairs stop iterating early instead of riding along with the largest
pair in the batch.
"""
import numpy as np
import jax
import jax.numpy as jnp

from ..graph.batch import batch_graphs, _round_up
from ..kernel.marginalized._solver import mlgk_solve, weight_by_p
from ..kernel.marginalized.starting_probability import Adhoc
from ..util.iterable import flatten

# total device bytes allowed for precomputed incidence one-hots
_ONEHOT_BUDGET = 1 << 29
# per-job one-hot element cap: precomputing pays only at molecule
# scale (it trims theta-sweep setup); at protein scale the solve
# dominates and the one-hots would be large constants in the program
_ONEHOT_JOB_ELEMS = 1 << 17


def _np_one_hot(indices, depth):
    """Host-side one-hot (f32). The incidence one-hots are static data;
    see the note at their use sites."""
    idx = np.asarray(indices)
    return (idx[..., None] == np.arange(depth)).astype(np.float32)


def _as_jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _onehots_on_device(onehots):
    """A job group's incidence one-hots, moved (in place) from the host
    to the default device on first use. They stay on the host until
    then, so that a sharded build (``parallel.gram``) places them with
    its mesh and no device ever holds all of them."""
    with jax.ensure_compile_time_eval():
        for k, v in onehots.items():
            if isinstance(v, np.ndarray):
                onehots[k] = jnp.asarray(v)
    return onehots


class GramFactory:
    """Produces traced Gram-matrix functions for a MarginalizedGraphKernel
    over a fixed graph set.

    Parameters
    ----------
    kernel: MarginalizedGraphKernel (or Normalization-wrapped)
    graphs: list of Graph
    normalize: bool
        If True, returns the cosine-normalized Gram matrix
        K_ij / sqrt(K_ii K_jj) (the standard choice for GPR on MLGK).
    buckets: 'auto' | bool
        Solve size-bucketed pair groups at their own padded shapes.
        'auto' enables bucketing whenever the graph set spans more than
        one padded-size class. An explicit ``False`` requests the
        single-batch path and also stands down ``union='auto'`` (a
        forced integer ``union`` factor still takes precedence and
        routes through the grouped machinery).
    node_align: int
        Padded node counts are rounded up to multiples of this.
    union: 'auto' | int | False
        Cross-product pair packing: pack ``k`` graphs per side into one
        disjoint-union "super-graph" at member-aligned node offsets.
        The MLGK system of a union pair is block-diagonal over the
        k x k member-pair tiles, so ONE CG solve at operand dims
        [k*M, k*N] yields k^2 kernel values. Unlike block-diagonal pair
        packing, the per-pair elementwise cost (T o H Hadamard, CG
        vector updates) stays CONSTANT in k — the k-fold redundancy
        lands only on the four one-hot contractions, whose
        molecule-sized operands are far below a matrix unit's tile.
        'auto' enables it on the pallas and edge backends with a
        per-class factor sized to ~128-node unions (for 'pallas', the
        largest that still fits one block's shared memory); an int
        forces the factor; False disables. The
        GRAPHDOT_UNION env var overrides: '1'/'true'/'auto' enable
        auto packing, '0'/'false' disable, an integer >= 2 forces the
        factor (case-insensitive).
    graphs2: list of Graph or None
        When given, the factory is rectangular: jobs are the full
        X x Y cross product and ``gram()`` returns ``[len(graphs),
        len(graphs2)]`` (requires ``normalize=False``; normalize with
        per-side diagonals). Both sides get their own size classes and
        union packing. This is how ``MarginalizedGraphKernel(X, Y)``
        (and hence GPR ``predict`` cross-Grams) reach the flagship
        union-packed throughput.
    kron_ranks: 'auto' | None | int | tuple
        Chebyshev ranks of the sum-of-Kronecker protein solver
        (``kernel/marginalized/_kron.py``). 'auto' (default) calibrates
        the per-feature rank against the ``factorization_error``
        diagnostic at the kernel's current hyperparameters when the
        backend is 'kron'; None uses the module
        default (``GRAPHDOT_KRON_RANK``); an int/tuple forces it. Call
        :meth:`recalibrate_kron` after large hyperparameter moves
        (e.g. a sharper edge length scale needs a denser grid).
    maxiter: int or None
        Cap on CG iterations per solve. The default (None) bounds each
        solve by its product-space dimension, like the reference solver.
        Inference loops (NUTS/HMC leapfrogs) should set a finite cap:
        within the posterior's typical set Jacobi-PCG converges in ~7-16
        iterations, while extreme-tail hyperparameters (q -> 0, kernel
        -> 1) make the system so ill-conditioned that CG burns the full
        n1*n2 iterations computing a log-density that is astronomically
        low anyway — a capped solve is 5-10x cheaper there and the
        sampler rejects/diverges on such points regardless.
    """

    def __init__(self, kernel, graphs, normalize=True, buckets='auto',
                 node_align=8, maxiter=None, union='auto', graphs2=None,
                 kron_ranks='auto'):
        if maxiter is None:
            self._maxiter_cap = 10000
        elif int(maxiter) >= 1:
            self._maxiter_cap = int(maxiter)
        else:
            raise ValueError(f'maxiter must be >= 1, got {maxiter!r}.')
        # unwrap a Normalization fix if present
        if hasattr(kernel, 'kernel') and not hasattr(kernel, 'node_kernel'):
            kernel = kernel.kernel
            normalize = True
        self.kernel = kernel
        self.graphs = list(graphs)
        # rectangular (X, Y) factory: jobs are the full cross product
        # and gram() returns [n, n2]. Used by the sklearn API path for
        # kernel(X, Y) (e.g. GPR predict cross-Grams) so it shares the
        # union-packed machinery with the symmetric build (one hot
        # path, like the reference's single backend call,
        # graphdot/kernel/marginalized/_kernel.py:114).
        self._two = graphs2 is not None
        if self._two:
            if normalize:
                raise ValueError(
                    'normalize is not supported for rectangular (X, Y) '
                    'factories; normalize with per-side diagonals.')
            self.graphs2 = list(graphs2)
        else:
            self.graphs2 = self.graphs
        self.normalize = normalize

        mode = kernel.backend.mode
        self._mode = mode
        n = len(self.graphs)
        n2 = len(self.graphs2)
        self._n = n
        self._n2 = n2
        if self._two:
            ii, jj = np.indices((n, n2))
            iu, ju = ii.ravel(), jj.ravel()
        else:
            iu, ju = np.triu_indices(n)
        self._iu = jnp.asarray(iu.astype(np.int32))
        self._ju = jnp.asarray(ju.astype(np.int32))

        self._n_p = len(list(flatten(kernel.p.theta)))
        self._active = np.asarray(kernel.active_theta_mask)
        self._full0 = np.asarray(kernel.flat_hyperparameters, dtype=float)

        # ---- global batch (used by the sharded path and as the
        # single-group fallback) ----
        batch = batch_graphs(self.graphs, node_align=node_align)
        self._n_pad = batch.node_mask.shape[1]
        self._batch = self._batch_dict(batch)
        if self._two:
            batch2 = batch_graphs(self.graphs2, node_align=node_align)
            self._n_pad2 = batch2.node_mask.shape[1]
            self._batch2 = self._batch_dict(batch2)
        else:
            batch2 = batch
            self._n_pad2 = self._n_pad
            self._batch2 = self._batch

        self._p_fixed = None
        self._p_fixed2 = None
        if isinstance(kernel.p, Adhoc):
            self._p_fixed = jnp.asarray(
                self._adhoc_p_rows(range(n), self._n_pad))
            self._p_fixed2 = self._p_fixed if not self._two else \
                jnp.asarray(self._adhoc_p_rows(
                    range(n2), self._n_pad2, side=2))
        # ---- size classes ----
        sizes = [len(g.nodes) for g in self.graphs]
        classes = {}
        for gi, s in enumerate(sizes):
            classes.setdefault(_round_up(s, node_align), []).append(gi)
        if self._two:
            classes2 = {}
            for gi, s in enumerate(
                    len(g.nodes) for g in self.graphs2):
                classes2.setdefault(
                    _round_up(s, node_align), []).append(gi)
        else:
            classes2 = classes
        # an explicit buckets=False is a request for the single-batch
        # path; union='auto' then stands down (only a forced int
        # factor overrides it) — see the buckets/union docstrings
        buckets_off = buckets is False
        if buckets == 'auto':
            buckets = len(classes) > 1

        # ---- union packing resolution ----
        import os
        env_union = os.environ.get('GRAPHDOT_UNION')
        if env_union is not None:
            v = env_union.strip().lower()
            if v in ('0', 'false', 'off', 'no'):
                union = False
            elif v in ('1', 'true', 'on', 'yes', 'auto'):
                union = 'auto'
            else:
                try:
                    union = int(v)
                except ValueError:
                    raise ValueError(
                        f'GRAPHDOT_UNION={env_union!r} is not a valid '
                        "value: use 'auto'/'1'/'true' to enable, "
                        "'0'/'false' to disable, or an integer >= 2 "
                        'to force the pack factor.')
        if union == 'auto':
            self._union = mode in ('pallas', 'edge') and not buckets_off
            self._union_force_k = None
        elif union:
            self._union = True
            self._union_force_k = int(union)
        else:
            self._union = False
            self._union_force_k = None

        # union packing runs through the grouped path (a plain pair
        # group is the k=1 special case of a union group)
        multi = len(classes) > 1 or len(classes2) > 1
        self._bucketed = (bool(buckets) and multi) or self._union

        if self._bucketed:
            self._build_groups(classes, classes2, node_align, iu, ju)
            if not (bool(buckets) and multi) \
                    and self._union_force_k is None \
                    and all(g['k1'] == 1 and g['k2'] == 1
                            for g in self._groups):
                # union='auto' resolved to k=1 everywhere (e.g. large
                # graph classes) and bucketing itself is not wanted:
                # the grouped path would add per-class-pair programs
                # with zero packing benefit — use the single batch
                self._bucketed = False
                self._groups = None
                self._union = False
        if not self._bucketed:
            self._groups = None
            self._onehots = {}
            n_pairs = len(iu)
            if mode != 'dense':
                m_pad = batch.esrc.shape[1]
                m_pad2 = batch2.esrc.shape[1]
                cost = 4 * 2 * n_pairs * (
                    m_pad * self._n_pad + m_pad2 * self._n_pad2)
                small_jobs = max(m_pad * self._n_pad,
                                 m_pad2 * self._n_pad2) \
                    <= _ONEHOT_JOB_ELEMS
                if cost < _ONEHOT_BUDGET and small_jobs:
                    # numpy until first use (_onehots_on_device)
                    oh_src = _np_one_hot(batch.esrc, self._n_pad)
                    oh_dst = _np_one_hot(batch.edst, self._n_pad)
                    if self._two:
                        oh_src2 = _np_one_hot(batch2.esrc, self._n_pad2)
                        oh_dst2 = _np_one_hot(batch2.edst, self._n_pad2)
                    else:
                        oh_src2, oh_dst2 = oh_src, oh_dst
                    iu_h = np.asarray(self._iu)
                    ju_h = np.asarray(self._ju)
                    self._onehots = {
                        'oh_src_1': oh_src[iu_h],
                        'oh_dst_1': oh_dst[iu_h],
                        'oh_src_2': oh_src2[ju_h],
                        'oh_dst_2': oh_dst2[ju_h],
                    }

        # ---- kron rank calibration (consumes the
        # factorization_error diagnostic) ----
        self._kron_feats = None
        if self._mode != 'dense':
            self._kron_feats = (batch.edge_elist_feats,
                                np.asarray(batch.ew),
                                batch2.edge_elist_feats,
                                np.asarray(batch2.ew))
        if kron_ranks == 'auto':
            self._kron_ranks = None
            if self._kron_possible():
                self._kron_ranks, _ = self._calibrate_kron()
        elif kron_ranks is None or np.isscalar(kron_ranks):
            self._kron_ranks = kron_ranks
        else:
            self._kron_ranks = tuple(int(r) for r in kron_ranks)

    def _kron_possible(self):
        """Whether this factory's job groups take the sum-of-Kronecker
        path: the kron backend, with kron-eligible edge features."""
        if self._mode != 'kron' or self._kron_feats is None:
            return False
        from ..kernel.marginalized._kron import _plain_scalar_columns
        f1, _, f2, _ = self._kron_feats
        f1 = _plain_scalar_columns(f1)
        f2 = _plain_scalar_columns(f2)
        return not (f1 is None or f2 is None or set(f1) != set(f2)
                    or len(f1) > 2)

    def _calibrate_kron(self, theta_log_active=None):
        """Choose the per-feature Chebyshev ranks of the kron solver at
        concrete hyperparameters (the current kernel theta by default)
        by escalating until ``factorization_error`` < tolerance."""
        import contextlib
        from ..kernel.marginalized._kron import calibrate_ranks
        from ..kernel.marginalized._solver import _apply_on_features
        kernel = self.kernel
        if theta_log_active is None:
            full = self._full0.copy()
        else:
            full = np.asarray(jax.device_get(
                self.full_theta(jnp.asarray(
                    theta_log_active, dtype=jnp.float32))))
        nk = kernel.node_kernel.n_theta
        off = self._n_p + 1 + nk
        te = jnp.asarray(
            full[off:off + kernel.edge_kernel.n_theta],
            dtype=jnp.float32)
        f1, ew1, f2, ew2 = self._kron_feats
        try:
            cpu = jax.devices('cpu')[0]
            ctx = jax.default_device(cpu)
        except RuntimeError:
            ctx = contextlib.nullcontext()
        with ctx:
            return calibrate_ranks(
                _apply_on_features, kernel.edge_kernel, te,
                {k: jnp.asarray(v) for k, v in f1.items()},
                jnp.asarray(ew1),
                {k: jnp.asarray(v) for k, v in f2.items()},
                jnp.asarray(ew2))

    def recalibrate_kron(self, theta_log_active):
        """Re-run kron rank calibration at a new (concrete) theta and
        update the factory. Returns the new ranks (None when the kron
        path is not in play). Traced functions obtained before the
        call keep the old ranks — re-jit ``factory.gram`` after
        this."""
        if not self._kron_possible():
            return None
        self._kron_ranks, _ = self._calibrate_kron(theta_log_active)
        return self._kron_ranks

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    def _batch_dict(self, batch):
        bd = {
            'node_mask': jnp.asarray(batch.node_mask),
            'degree': jnp.asarray(batch.degree),
            'node_feats': _as_jnp_tree(batch.node_feats),
        }
        if self._mode == 'dense':
            bd['adj'] = jnp.asarray(batch.adj)
            bd['edge_feats'] = _as_jnp_tree(batch.edge_feats)
        else:
            for f in ('esrc', 'edst', 'ew'):
                bd[f] = jnp.asarray(getattr(batch, f))
            bd['edge_elist_feats'] = _as_jnp_tree(batch.edge_elist_feats)
        return bd

    def _adhoc_p_rows(self, indices, n_pad, side=1):
        """Evaluate an Adhoc starting probability on the given graphs,
        in node order, padded to ``n_pad``."""
        graph_list = self.graphs if side == 1 else self.graphs2
        pf = np.zeros((len(list(indices)), n_pad), dtype=np.float32)
        for r, gi in enumerate(indices):
            g = graph_list[gi]
            p_values, _ = self.kernel.p(g.nodes)
            p_values = np.asarray(p_values, dtype=np.float32)
            order = np.argsort(np.asarray(g.nodes['!i']))
            pf[r, :len(g.nodes)] = p_values[order]
        return pf

    def _union_k(self, ck, mk, n_members):
        """Union-pack factor for a size class: unions of up to ~128 nodes
        and 512 directed edges per side; for the fused kernel, the
        largest factor whose super-pair still fits one block's shared
        memory (``pallas_pcg.fits``)."""
        if not self._union:
            return 1
        if self._union_force_k is not None:
            k = self._union_force_k
        else:
            k = max(1, min(8, 128 // ck, 512 // max(mk, 1)))
        k = max(1, min(k, n_members))
        if self._mode == 'pallas':
            from ..ops.pallas_pcg import fits
            while k > 1 and not fits(k * mk, k * mk, k * ck, k * ck):
                k -= 1
        return k

    @staticmethod
    def _union_rows(arr, blocks, offsets=None):
        """Stack member rows of ``arr`` [n_mem, D, ...] into union rows
        [n_blocks, k*D, ...] per ``blocks`` [n_blocks, k] (member index
        or -1 for a phantom slot, which picks the appended zero row).
        ``offsets`` [k] is added per slot (node-index columns)."""
        arr = np.asarray(arr)
        ext = np.concatenate([arr, np.zeros_like(arr[:1])], axis=0)
        out = ext[blocks]                     # [n_blocks, k, D, ...]
        if offsets is not None:
            out = out + offsets[None, :, None]
        return out.reshape(out.shape[0], out.shape[1] * out.shape[2],
                           *out.shape[3:])

    def _build_side_meta(self, classes, node_align, side):
        """Per-size-class union metadata for one side of the job list."""
        graph_list = self.graphs if side == 1 else self.graphs2
        meta = {}
        for ck in sorted(classes):
            members = classes[ck]
            n_mem = len(members)
            batch = batch_graphs(
                [graph_list[gi] for gi in members],
                n_pad=ck, node_align=node_align)
            mk = 0 if self._mode == 'dense' else batch.esrc.shape[1]
            k = self._union_k(ck, mk, n_mem)
            n_blocks = -(-n_mem // k)
            blocks = np.full((n_blocks, k), -1, dtype=np.int64)
            blocks.flat[:n_mem] = np.arange(n_mem)
            glob = np.full((n_blocks, k), -1, dtype=np.int64)
            glob.flat[:n_mem] = np.asarray(members)
            counts = np.array(
                [len(graph_list[gi].nodes) for gi in members])
            ext_counts = np.concatenate([counts, [10 ** 9]])
            min_nodes = ext_counts[blocks].min(axis=1)

            if k == 1:
                bd = self._batch_dict(batch)
            else:
                offs = (np.arange(k) * ck).astype(np.int64)
                gather = lambda a: self._union_rows(a, blocks)  # noqa
                bd = {
                    'node_mask': jnp.asarray(gather(batch.node_mask)),
                    'degree': jnp.asarray(gather(batch.degree)),
                    'node_feats': jax.tree_util.tree_map(
                        lambda a: jnp.asarray(gather(a)),
                        batch.node_feats),
                    'esrc': jnp.asarray(self._union_rows(
                        batch.esrc, blocks, offs)),
                    'edst': jnp.asarray(self._union_rows(
                        batch.edst, blocks, offs)),
                    'ew': jnp.asarray(gather(batch.ew)),
                    'edge_elist_feats': jax.tree_util.tree_map(
                        lambda a: jnp.asarray(gather(a)),
                        batch.edge_elist_feats),
                }
            pfix = None
            if isinstance(self.kernel.p, Adhoc):
                rows = self._adhoc_p_rows(members, ck, side=side)
                pfix = jnp.asarray(
                    self._union_rows(rows, blocks) if k > 1 else rows)
            meta[ck] = dict(
                k=k, mk=mk, batch=bd, pfix=pfix, blocks=blocks,
                glob=glob, min_nodes=min_nodes, n_blocks=n_blocks,
            )
        return meta

    def _build_groups(self, classes, classes2, node_align, iu, ju):
        """Per-size-class union batches plus block-pair job groups.

        Every group is a "union group": k graphs per side packed into
        disjoint-union super-graphs at member-aligned node offsets
        (k = 1 reproduces the plain per-pair grouping). One solve of a
        super-pair yields the k1 x k2 tile of member kernel values —
        see the ``union`` parameter doc. For two-sided (rectangular)
        factories the block-pair list is the full cross product of the
        two sides' union blocks.
        """
        meta = self._build_side_meta(classes, node_align, side=1)
        meta2 = meta if not self._two else \
            self._build_side_meta(classes2, node_align, side=2)

        # block-pair job lists per class pair
        if self._two:
            pairs = [(ca, cb) for ca in sorted(meta)
                     for cb in sorted(meta2)]
        else:
            cks = sorted(meta)
            pairs = []
            for a_i, ca in enumerate(cks):
                for cb in cks[a_i:]:
                    pairs.append((ca, cb))

        # one-hot byte budget: split pro-rata by group demand
        demands = {}
        if self._mode != 'dense':
            for ca, cb in pairs:
                ma, mb = meta[ca], meta2[cb]
                if not self._two and ca == cb:
                    s = ma['n_blocks'] * (ma['n_blocks'] + 1) // 2
                else:
                    s = ma['n_blocks'] * mb['n_blocks']
                demands[(ca, cb)] = 4 * 2 * s * (
                    ma['k'] ** 2 * ma['mk'] * ca
                    + mb['k'] ** 2 * mb['mk'] * cb)
        small_jobs = all(
            max(mm['k'] ** 2 * mm['mk'] * ck
                for mm, ck in ((meta[ca], ca), (meta2[cb], cb)))
            <= _ONEHOT_JOB_ELEMS
            for ca, cb in pairs) if self._mode != 'dense' else True
        within_budget = (sum(demands.values()) < _ONEHOT_BUDGET
                         and small_jobs)

        self._groups = []
        for ca, cb in pairs:
            ma, mb = meta[ca], meta2[cb]
            if not self._two and ca == cb:
                bi, bj = np.triu_indices(ma['n_blocks'])
            else:
                bi, bj = map(np.ravel, np.meshgrid(
                    np.arange(ma['n_blocks']),
                    np.arange(mb['n_blocks']), indexing='ij'))
            n = self._n
            gi = ma['glob'][bi]          # [S, k1], -1 phantom
            gj = mb['glob'][bj]          # [S, k2]
            grp = {
                'ca': ca, 'cb': cb,
                'k1': ma['k'], 'k2': mb['k'],
                'batch1': ma['batch'], 'batch2': mb['batch'],
                'pfix1': ma['pfix'], 'pfix2': mb['pfix'],
                'gi': gi.astype(np.int64),
                'gj': gj.astype(np.int64),
                # device-side scatter indices: phantom -> n/n2 (the
                # last row/col of the padded Gram is discarded)
                'gi_pad': jnp.asarray(
                    np.where(gi < 0, n, gi).astype(np.int32)),
                'gj_pad': jnp.asarray(
                    np.where(gj < 0, self._n2, gj).astype(np.int32)),
                'idx1': jnp.asarray(bi.astype(np.int32)),
                'idx2': jnp.asarray(bj.astype(np.int32)),
                'tol_n1': jnp.asarray(
                    ma['min_nodes'][bi].astype(np.float32)),
                'tol_n2': jnp.asarray(
                    mb['min_nodes'][bj].astype(np.float32)),
                'onehots': {},
            }
            if self._mode != 'dense' and within_budget:
                for side, (mm, ck, loc) in enumerate(
                        [(ma, ca, bi), (mb, cb, bj)]):
                    depth = mm['k'] * ck
                    for nm in ('src', 'dst'):
                        # numpy until first use (_onehots_on_device)
                        grp['onehots'][f'oh_{nm}_{side + 1}'] = \
                            _np_one_hot(
                                np.asarray(mm['batch']['e' + nm])[loc],
                                depth)
            self._groups.append(grp)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def _group_maxiter(self, grp):
        """Finite-termination iteration bound for one job group. For
        union groups, CG on the packed system (dimension k1*ca*k2*cb)
        sees the union of the member-pair spectra, so the exact-
        arithmetic bound is the full packed dimension, not ca*cb:
        slow super-pairs would otherwise be silently
        preempted with the shortfall only visible via with_residual."""
        return min(grp.get('k1', 1) * grp['ca']
                   * grp.get('k2', 1) * grp['cb'],
                   self._maxiter_cap)

    @property
    def n_active(self):
        return int(self._active.sum())

    @property
    def theta0(self):
        """Current log-scale active hyperparameters of the kernel."""
        return np.log(self._full0[self._active])

    def full_theta(self, theta_log_active):
        """Embed the log-scale active theta into the full linear-scale
        hyperparameter vector (fixed entries keep their values)."""
        full = jnp.asarray(self._full0, dtype=jnp.float32)
        return full.at[np.where(self._active)[0]].set(
            jnp.exp(theta_log_active).astype(jnp.float32)
        )

    def _group_ops(self, batch1, batch2, idx1, idx2, onehots,
                   tol_n1=None, tol_n2=None):
        """Assemble the solver operand dict for one job group, gathering
        per-side features from (possibly distinct) class batches.
        ``tol_n1``/``tol_n2`` are per-job min member node counts (union
        groups); without them the solver falls back to the per-pair
        mask counts."""
        def g(tree, idx):
            return jax.tree_util.tree_map(lambda a: a[idx], tree)

        ops = {
            'node_feats_1': g(batch1['node_feats'], idx1),
            'node_feats_2': g(batch2['node_feats'], idx2),
            'node_mask_1': batch1['node_mask'][idx1],
            'node_mask_2': batch2['node_mask'][idx2],
            'degree_1': batch1['degree'][idx1],
            'degree_2': batch2['degree'][idx2],
            'ftol': jnp.float32(self.kernel.ftol),
        }
        if self._mode == 'dense':
            ops['adj_1'] = batch1['adj'][idx1]
            ops['adj_2'] = batch2['adj'][idx2]
            ops['edge_feats_1'] = g(batch1['edge_feats'], idx1)
            ops['edge_feats_2'] = g(batch2['edge_feats'], idx2)
        else:
            for f in ('esrc', 'edst', 'ew'):
                ops[f + '_1'] = batch1[f][idx1]
                ops[f + '_2'] = batch2[f][idx2]
            ops['edge_elist_feats_1'] = g(
                batch1['edge_elist_feats'], idx1)
            ops['edge_elist_feats_2'] = g(
                batch2['edge_elist_feats'], idx2)
            # theta-independent incidence one-hots, built once per
            # factory (saves ~1/3 of the per-call setup cost)
            ops.update(_onehots_on_device(onehots))
        if tol_n1 is not None:
            ops['tol_n1'] = tol_n1
            ops['tol_n2'] = tol_n2
        return ops

    def _group_r(self, theta, ops, pfix1, pfix2, idx1, idx2, lmin,
                 maxiter, with_residual=False, tile=None):
        """Solve one job group and reduce to kernel values: per-pair
        scalars, or — for union groups, via ``tile = (k1, ca, k2, cb)``
        — the [k1, k2] member tile of each super-pair (sum over each
        member-aligned block of the p-weighted solution)."""
        kernel = self.kernel
        out = mlgk_solve(
            theta, ops, knode=kernel.node_kernel,
            kedge=kernel.edge_kernel, n_p_theta=self._n_p, lmin=lmin,
            mode=self._mode, maxiter=maxiter,
            kron_ranks=self._kron_ranks,
            return_resnorm=with_residual,
        )
        x, Vx, valid = out[:3]
        pf1 = pfix1[idx1] if pfix1 is not None else None
        pf2 = pfix2[idx2] if pfix2 is not None else None
        p1 = kernel.p.apply(theta[:self._n_p], ops['node_mask_1'], pf1)
        p2 = kernel.p.apply(theta[:self._n_p], ops['node_mask_2'], pf2)
        R = weight_by_p(x, p1, p2)
        if tile is None:
            r = jnp.sum(R, axis=(1, 2))
        else:
            k1, ca, k2, cb = tile
            S = R.shape[0]
            r = jnp.sum(
                R.reshape(S, k1, ca, k2, cb), axis=(2, 4))
        return (r, jnp.max(out[3])) if with_residual else r

    def _group_ops_solve(self, batch1, batch2, pfix1, pfix2, lmin,
                         maxiter, tile, theta, idx1, idx2,
                         tol_n1=None, tol_n2=None, *onehots):
        """Solve one job group given raw local index arrays. Used by the
        sharded path (``parallel.gram.sharded_gram_fn``), where ``idx1``/
        ``idx2`` are the local shard of the job list. When the factory
        precomputed per-job incidence one-hots, their local shards are
        passed positionally (src1, dst1, src2, dst2); otherwise they are
        rebuilt in-trace from the index shard. ``tile`` is the union
        tile spec (k1, ca, k2, cb) or None for per-pair groups."""
        oh = {}
        if onehots:
            oh = dict(zip(
                ('oh_src_1', 'oh_dst_1', 'oh_src_2', 'oh_dst_2'),
                onehots
            ))
        ops = self._group_ops(batch1, batch2, idx1, idx2, oh,
                              tol_n1=tol_n1, tol_n2=tol_n2)
        return self._group_r(
            theta, ops, pfix1, pfix2, idx1, idx2, lmin, maxiter,
            tile=tile)

    def iteration_stats(self, theta_log_active, lmin=0, mode=None):
        """Per-group CG iteration counts at ``theta`` (host-side
        diagnostic; the instrument behind the benches' FLOP/MFU
        accounting).

        Runs the XLA PCG with per-pair iteration counting on the same
        operands/tolerances as the production solve (the fused kernel
        executes the same Jacobi-PCG recurrence, so the counts
        transfer).

        Returns a list of dicts, one per job group, with keys
        ``n_jobs``, ``ca``/``cb`` (padded MEMBER node classes),
        ``m1``/``m2`` (per-job OPERAND directed-edge dims, i.e. k*m for
        union groups), ``k1``/``k2`` (union factors), ``iters``
        ([n_jobs] int array — per union super-pair when k > 1),
        ``gi``/``gj`` (global member graph indices, [n_jobs] or
        [n_jobs, k] with -1 phantoms).
        """
        theta = self.full_theta(
            jnp.asarray(theta_log_active, dtype=jnp.float32))
        if self._groups is None:
            entries = [{
                'batch1': self._batch, 'batch2': self._batch2,
                'idx1': self._iu, 'idx2': self._ju,
                'onehots': self._onehots,
                'ca': self._n_pad, 'cb': self._n_pad2,
                'k1': 1, 'k2': 1,
                'gi': self._iu, 'gj': self._ju,
                'tol_n1': None, 'tol_n2': None,
            }]
        else:
            entries = self._groups
        if mode is None:
            mode = 'edge' if self._mode == 'pallas' else self._mode
        stats = []
        for grp in entries:
            ops = self._group_ops(
                grp['batch1'], grp['batch2'],
                grp['idx1'], grp['idx2'], grp.get('onehots', {}),
                tol_n1=grp['tol_n1'], tol_n2=grp['tol_n2'])
            maxiter = self._group_maxiter(grp)

            def iters_fn(t, ops=ops, mi=maxiter):
                return mlgk_solve(
                    t, ops, knode=self.kernel.node_kernel,
                    kedge=self.kernel.edge_kernel,
                    n_p_theta=self._n_p, lmin=lmin, mode=mode,
                    maxiter=mi, kron_ranks=self._kron_ranks,
                    return_iters=True)[3]

            iters = np.asarray(jax.jit(iters_fn)(theta))
            m1 = m2 = 0
            if mode != 'dense':
                m1 = ops['esrc_1'].shape[1]
                m2 = ops['esrc_2'].shape[1]
            stats.append({
                'n_jobs': int(len(np.asarray(grp['gi']))),
                'ca': int(grp['ca']), 'cb': int(grp['cb']),
                'k1': int(grp.get('k1', 1)),
                'k2': int(grp.get('k2', 1)),
                'm1': int(m1), 'm2': int(m2),
                'iters': iters,
                'gi': np.asarray(grp['gi']),
                'gj': np.asarray(grp['gj']),
            })
        return stats

    def gram(self, theta_log_active, lmin=0, with_residual=False):
        """The (optionally normalized) Gram matrix as a traced function
        of the log-scale active hyperparameters. With ``with_residual``,
        also returns the worst final-residual / tolerance ratio across
        all pair solves (> 1 signals that the ``maxiter`` cap preempted
        CG convergence at this theta)."""
        theta = self.full_theta(theta_log_active)
        K = jnp.zeros((self._n, self._n2), dtype=jnp.float32)
        worst = jnp.float32(0.0)

        if self._groups is None:
            ops = self._group_ops(
                self._batch, self._batch2, self._iu, self._ju,
                self._onehots)
            maxiter = min(self._n_pad * self._n_pad2, self._maxiter_cap)
            r = self._group_r(
                theta, ops, self._p_fixed, self._p_fixed2,
                self._iu, self._ju, lmin, maxiter,
                with_residual=with_residual)
            if with_residual:
                r, worst = r
            K = K.at[self._iu, self._ju].set(r)
            if not self._two:
                K = K.at[self._ju, self._iu].set(r)
        else:
            # scatter into a padded Gram: the last row/col absorbs the
            # phantom members of partial union blocks
            Kp = jnp.zeros((self._n + 1, self._n2 + 1),
                           dtype=jnp.float32)
            for grp in self._groups:
                ops = self._group_ops(
                    grp['batch1'], grp['batch2'],
                    grp['idx1'], grp['idx2'], grp['onehots'],
                    tol_n1=grp['tol_n1'], tol_n2=grp['tol_n2'])
                maxiter = self._group_maxiter(grp)
                tile = (grp['k1'], grp['ca'], grp['k2'], grp['cb'])
                r = self._group_r(
                    theta, ops, grp['pfix1'], grp['pfix2'],
                    grp['idx1'], grp['idx2'], lmin, maxiter,
                    with_residual=with_residual, tile=tile)
                if with_residual:
                    r, ratio = r
                    worst = jnp.maximum(worst, ratio)
                gi = grp['gi_pad'][:, :, None]     # [S, k1, 1]
                gj = grp['gj_pad'][:, None, :]     # [S, 1, k2]
                Kp = Kp.at[gi, gj].set(r)
                if not self._two:
                    Kp = Kp.at[gj, gi].set(r)
            K = Kp[:self._n, :self._n2]

        if self.normalize:
            d = jnp.sqrt(jnp.diagonal(K))
            K = K / d[:, None] / d[None, :]
        return (K, worst) if with_residual else K
