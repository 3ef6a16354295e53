"""Sum-of-Kronecker MLGK solver for protein-scale pairs.

The edge-factored matvec ``S1^T (T o (D1 Y D2^T)) S2`` couples the two
graphs through the M1 x M2 edge-kernel matrix ``T`` — at protein scale
(M ~ 1e4 directed contacts) T reaches GBs per pair and the solve is
bound by device-memory bandwidth no matter how it is scheduled (every CG
iteration re-reads T).

For the workload the reference's protein benchmark actually runs
(``example/perfbench/protein-time-to-solution.py``: contact maps whose
edges carry scalar features such as the residue distance), T has low
*numerical* rank: ``T[e1, e2] = w1 w2 k_edge(x[e1], y[e2])`` is a smooth
kernel of a few scalars, so (tensor-grid) Chebyshev interpolation gives

    k(x, y) ~= sum_{p,q} L_p(x) C_pq L_q(y),   C_pq = k(t_p, t_q)

with R ~ 16-48 grid nodes per scalar feature at near-machine precision
(multiple features use the tensor product of per-feature bases, so the
grid size is the product of per-feature ranks). Substituting collapses
the edge space entirely:

    offdiag(Y) = sum_p A1_p Y B_p^T,   B_p = sum_q C_pq A2_q
    A1_p[i, j] = sum_{e: src=i, dst=j} w[e] L_p(x[e])

— R dense node-space [N, N] matmuls per matvec: no T, no edge-space
operands, every FLOP in large dense matmuls. Per CG
iteration this is R*(N1^2 N2 + N1 N2^2) FLOPs vs the edge path's
~2*M1*M2*(N1+N2): ~10x fewer at 300 residues, ~50x at 1000, with HBM
traffic dropping from O(M1*M2) to O(R*N^2).

The rank sum is FUSED into two standard batched matmuls by stacking the
A-factors along the row dimension (A1 rows interleaved (node, rank),
B2 rows (rank, node)):

    G  = A1s @ Y            [c, n1*R, n1] x [c, n1, n2] -> [c, n1*R, n2]
    out = G' @ B2s          [c, n1, R*n2] x [c, R*n2, n2]

where G' is G re-viewed with the rank axis folded into the contraction
columns. One contraction of depth n1 and one of depth R*n2 — large
enough to fill a matrix unit's tiles — replace the R sequential small
matmuls of the naive form. ``GRAPHDOT_KRON_FUSED=0`` restores the
sequential loop.

All theta-dependence sits in the C matrix (folded into the side-2
basis pre-scatter); the basis values and scatter patterns are data.
Pairs are solved in chunks so the [chunk, n*R, n] A-stacks bound memory
instead of scaling with the full pair batch.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# Chebyshev nodes per scalar feature. 32 first-kind nodes interpolate
# the bench's SquareExponential(3.0) over a ~30 A contact-length domain
# to ~1e-7 relative; sharper kernels (small length scale relative to
# the data range) need more. `calibrate_ranks` consumes the
# `factorization_error` diagnostic to choose the rank automatically at
# concrete hyperparameters; the env var forces a fixed value.
DEFAULT_RANK = int(os.environ.get('GRAPHDOT_KRON_RANK', 32))
# candidate ranks for auto-calibration, and the error tolerance the
# chosen rank must meet (max |k - k_approx| over sampled edge pairs;
# edge-kernel values are O(1), so this is an absolute-scale tolerance
# aligned with the solver's 1e-5..1e-4 accuracy contract)
RANK_CANDIDATES = (8, 12, 16, 24, 32, 48, 64)
RANK_TOL = float(os.environ.get('GRAPHDOT_KRON_RANK_TOL', 1e-6))
# per-side cap on the total tensor-grid size (product of per-feature
# ranks): matvec FLOPs scale linearly with it
MAX_GRID = int(os.environ.get('GRAPHDOT_KRON_MAX_GRID', 96))


def _plain_scalar_columns(feats):
    """The dict of plain scalar feature columns, or None if any column
    is variable-length ((values, mask) tuple) or non-2D."""
    if not feats:
        return None
    for v in feats.values():
        if isinstance(v, tuple) or np.ndim(v) != 2:
            return None
    return feats


def _cheb_nodes(lo, hi, R):
    """First-kind Chebyshev nodes on [lo, hi] and their barycentric
    weights (O'Neill/Trefethen form; scale-invariant up to a common
    factor that cancels in the barycentric ratio)."""
    i = jnp.arange(R, dtype=jnp.float32)
    ang = jnp.pi * (2 * i + 1) / (2 * R)
    t = (lo + hi) / 2 + (hi - lo) / 2 * jnp.cos(ang)
    w = (-1.0) ** i * jnp.sin(ang)
    return t, w


def _cheb_basis(x, t, w):
    """Barycentric Lagrange basis values L_p(x): [..., R]. Exact hits
    x == t_p resolve to the one-hot row (the 0/0 limit)."""
    d = x[..., None] - t                        # [..., R]
    hit = d == 0.0
    any_hit = jnp.any(hit, axis=-1, keepdims=True)
    ratio = w / jnp.where(hit, 1.0, d)
    L_smooth = ratio / jnp.sum(ratio, axis=-1, keepdims=True)
    return jnp.where(any_hit, hit.astype(x.dtype), L_smooth)


def _feature_domain(x1, ew1, x2, ew2):
    """Joint range of the real (weight-carrying) values of one scalar
    edge feature on both sides; padding edges (w == 0) are excluded."""
    big = jnp.float32(3e38)

    def lohi(x, ew):
        real = ew != 0
        lo = jnp.min(jnp.where(real, x, big))
        hi = jnp.max(jnp.where(real, x, -big))
        return lo, hi

    lo1, hi1 = lohi(x1, ew1)
    lo2, hi2 = lohi(x2, ew2)
    lo = jnp.minimum(lo1, lo2)
    hi = jnp.maximum(hi1, hi2)
    lo = jnp.minimum(lo, hi)                    # empty-graph guard
    hi = jnp.where(hi - lo < 1e-6, lo + 1.0, hi)
    return lo, hi


def _normalize_ranks(ranks, names):
    """Per-feature rank tuple for the name-sorted feature columns."""
    if ranks is None:
        R = DEFAULT_RANK
        if len(names) > 1:
            # keep the tensor grid within the FLOP cap by default
            while R ** len(names) > MAX_GRID and R > 4:
                R = {32: 8, 24: 8, 16: 8, 48: 8, 64: 8, 12: 8}.get(R, 8)
        ranks = (R,) * len(names)
    elif np.isscalar(ranks):
        ranks = (int(ranks),) * len(names)
    else:
        ranks = tuple(int(r) for r in ranks)
        assert len(ranks) == len(names)
    return ranks


def _outer_basis(Ls):
    """Tensor-product combination of per-feature basis values."""
    L = Ls[0]
    for Lf in Ls[1:]:
        L = L[..., :, None] * Lf[..., None, :]
        L = L.reshape(*L.shape[:-2], -1)
    return L


def _grid_axes(feats1, feats2, ew1, ew2, ranks):
    """Per-feature Chebyshev nodes/weights over the joint data domain,
    plus the flattened tensor-grid coordinate dict (first sorted
    feature outermost)."""
    names = sorted(feats1)
    axes = {}
    for name, R in zip(names, ranks):
        lo, hi = _feature_domain(feats1[name], ew1, feats2[name], ew2)
        t, w = _cheb_nodes(lo, hi, R)
        axes[name] = (lo, hi, t, w)
    ts = [axes[n][2] for n in names]
    mesh = jnp.meshgrid(*ts, indexing='ij') if len(ts) > 1 else ts
    grids = {name: g.reshape(-1) for name, g in zip(names, mesh)}
    return axes, grids


def _grid_basis(feats1, feats2, ew1, ew2, ranks):
    """Tensor-grid Chebyshev basis over the (name-sorted) scalar
    feature columns of both sides.

    Returns (L1 [..., Rg], L2 [..., Rg], grids: dict name -> [Rg] of
    grid coordinates), with Rg the product of per-feature ranks and the
    grid ordered with the first (sorted) feature outermost."""
    names = sorted(feats1)
    axes, grids = _grid_axes(feats1, feats2, ew1, ew2, ranks)
    Ls1, Ls2 = [], []
    for name in names:
        lo, hi, t, w = axes[name]
        # clamp into the interpolation domain before evaluating the
        # basis: padding edges carry feature 0, which can sit far
        # OUTSIDE [lo, hi], where the barycentric denominator suffers
        # catastrophic cancellation (inf/NaN that even the ew = 0
        # weight cannot kill, since NaN * 0 = NaN). Real features lie
        # inside by construction, so the clamp is the identity there.
        Ls1.append(_cheb_basis(
            jnp.clip(feats1[name], lo, hi), t, w))
        Ls2.append(_cheb_basis(
            jnp.clip(feats2[name], lo, hi), t, w))
    return _outer_basis(Ls1), _outer_basis(Ls2), grids


def _dense_grid_values(esrc, edst, ew, xcols, n_pad, names, axes):
    """Weighted tensor-grid basis values on the dense (i, j) node grid:
    [c, n_pad^2, Rg] with entry w_e * L(x_e) at each edge's (i, j) slot
    and 0 elsewhere.

    Two cheap [c, M]-update scatters (the edge weights, and each scalar
    feature) replace the much larger [c, M, Rg] float scatter-add of
    the stacked factors, and the basis is then evaluated DENSELY on the
    grid, which is pure elementwise work. Assumes at most one directed
    edge per (i, j) (the Graph contract); padding edges (w == 0) are
    parked in a trash slot."""
    c, M = esrc.shape
    flat = jnp.where(ew != 0, esrc * n_pad + edst, n_pad * n_pad)
    ci = jnp.arange(c)[:, None]
    Wg = jnp.zeros((c, n_pad * n_pad + 1), dtype=jnp.float32
                   ).at[ci, flat].add(ew)[:, :-1]
    Ls = []
    for f, name in enumerate(names):
        lo, hi, t, w = axes[name]
        Xg = jnp.zeros((c, n_pad * n_pad + 1), dtype=jnp.float32
                       ).at[ci, flat].set(xcols[:, :, f])[:, :-1]
        # empty slots hold 0 -> clamp to the domain so the barycentric
        # denominator stays finite (Wg = 0 kills their contribution)
        Ls.append(_cheb_basis(jnp.clip(Xg, lo, hi), t, w))
    return _outer_basis(Ls) * Wg[..., None]


def _edge_kernel_grid(apply_on_features, kedge, te, grids):
    """C[p, q] = k_edge(grid_p, grid_q) on the (flattened) tensor
    grid."""
    X = {name: g[:, None] for name, g in grids.items()}
    Y = {name: g[None, :] for name, g in grids.items()}
    return apply_on_features(kedge, te, X, Y)


def _assemble_stack(esrc, edst, ew, L, n_pad):
    """A_p[i, j] = sum_{e: src=i, dst=j} w[e] L_p(x[e]) for one side of
    a chunk: esrc/edst [c, M], ew [c, M], L [c, M, R] -> [c, R, N, N].
    Padding edges carry w = 0 and scatter nothing."""
    c, M, R = L.shape
    A = jnp.zeros((c, R, n_pad, n_pad), dtype=jnp.float32)
    vals = jnp.swapaxes(ew[:, :, None] * L, 1, 2)     # [c, R, M]
    ci = jnp.arange(c)[:, None, None]
    ri = jnp.arange(R)[None, :, None]
    return A.at[ci, ri, esrc[:, None, :], edst[:, None, :]].add(vals)




def factorization_error(apply_on_features, kedge, te, feats_1, ew1,
                        feats_2, ew2, ranks=None, n_sample=1024,
                        seed=0):
    """Max |k(x, y) - Chebyshev approx| over a random sample of real
    edge pairs — the runtime accuracy diagnostic for the Kronecker
    path (per-batch, any shapes).

    ``feats_1``/``feats_2`` are dicts of scalar feature columns (a
    single array is accepted for the one-feature case and treated as
    ``{'x': value}``)."""
    if not isinstance(feats_1, dict):
        feats_1 = {'x': feats_1}
        feats_2 = {'x': feats_2}
    names = sorted(feats_1)
    ranks = _normalize_ranks(ranks, names)
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)

    def sample(feats, ew, key):
        cols = {}
        # sample real-edge rows so multi-feature columns stay paired
        flat_w = ew.reshape(-1)
        p = (flat_w != 0).astype(jnp.float32)
        p = p / jnp.maximum(jnp.sum(p), 1.0)
        idx = jax.random.choice(key, flat_w.shape[0], (n_sample,), p=p)
        for name in names:
            cols[name] = feats[name].reshape(-1)[idx]
        return cols

    Xs = sample(feats_1, ew1, keys[0])
    Ys = sample(feats_2, ew2, keys[1])
    exact = apply_on_features(kedge, te, Xs, Ys)

    # evaluate the factorized approximation at the sampled pairs
    ones = jnp.ones((1, n_sample), dtype=jnp.float32)
    L1, L2, grids = _grid_basis(
        {n: Xs[n][None, :] for n in names},
        {n: Ys[n][None, :] for n in names},
        ones, ones, ranks)
    C = _edge_kernel_grid(apply_on_features, kedge, te, grids)
    approx = jnp.einsum('sp,pq,sq->s', L1[0], C, L2[0])
    return jnp.max(jnp.abs(exact - approx))


def calibrate_ranks(apply_on_features, kedge, te, feats_1, ew1,
                    feats_2, ew2, tol=None, candidates=None,
                    n_sample=2048):
    """Choose the smallest per-feature Chebyshev rank whose
    ``factorization_error`` is below ``tol`` at the given (concrete)
    edge hyperparameters — the auto-rank policy that consumes the
    diagnostic instead of merely exposing it.

    Host-side: call with concrete ``te`` (e.g. at factory construction
    or sklearn-API dispatch time, where theta is known) and pass the
    result as the static ``ranks`` of :func:`kron_mlgk_solve`. Returns
    ``(ranks, err)``: the per-feature rank tuple and its achieved
    factorization error. If even the largest candidate misses ``tol``
    (or the error plateaus above it — e.g. a discontinuous
    KroneckerDelta edge factor, which no polynomial grid interpolates),
    the best rung is returned with its (large) error and a warning;
    callers auto-selecting the kron path should reject it and fall
    back to the streaming/edge solver when ``err`` exceeds their
    accuracy contract."""
    import warnings
    if tol is None:
        tol = RANK_TOL
    if not isinstance(feats_1, dict):
        feats_1 = {'x': feats_1}
        feats_2 = {'x': feats_2}
    n_feat = len(feats_1)
    if candidates is None:
        candidates = (RANK_CANDIDATES if n_feat == 1
                      else (4, 6, 8, 12, 16, 24, 32))
    prev = None                       # (ranks, err) of the previous rung
    for R in candidates:
        err = float(factorization_error(
            apply_on_features, kedge, te, feats_1, ew1, feats_2, ew2,
            ranks=(R,) * n_feat, n_sample=n_sample))
        if err < tol:
            return (R,) * n_feat, err
        # plateau: the error stopped improving (the f32 evaluation
        # floor ~ sqrt(grid) * eps, or a non-smooth kernel) — more
        # nodes only cost FLOPs. Keep the cheaper rung if it was
        # already within 2x.
        if prev is not None and err > 0.5 * prev[1]:
            ranks_best, err_best = prev if prev[1] <= 2 * err \
                else ((R,) * n_feat, err)
            if err_best > 1e-4:
                warnings.warn(
                    f'kron rank calibration plateaued at '
                    f'R={ranks_best} with factorization error '
                    f'{err_best:.3g} > 1e-4; the edge kernel is not '
                    f'smooth enough for the Kronecker path — auto '
                    f'selection falls back to the streaming/edge '
                    f'solver.')
            return ranks_best, err_best
        prev = ((R,) * n_feat, err)
    if err > 1e-4:
        warnings.warn(
            f'kron rank calibration: largest candidate grid '
            f'(R={R}^{n_feat}) still has factorization error '
            f'{err:.3g} > 1e-4; the edge kernel is not smooth enough '
            f'for the Kronecker path — auto selection falls back to '
            f'the streaming/edge solver.')
    return (R,) * n_feat, err


def kron_mlgk_solve(theta_ops, *, apply_on_features, kedge, te,
                    maxiter, ranks=None, chunk=None,
                    solve_linear=None, return_resnorm=False,
                    return_iters=False):
    """Solve the batched MLGK systems with the sum-of-Kronecker matvec.

    ``theta_ops`` carries the already-computed N-space operands
    (diag_coef, precond_diag, b, tol) plus the raw edge lists
    (esrc/edst/ew [P, M]) and the scalar feature columns as dicts
    (``feats_1``/``feats_2``); see the call site in ``mlgk_solve``.
    ``ranks`` (static) is the per-feature Chebyshev rank tuple — see
    :func:`calibrate_ranks`.

    Returns x [P, n1, n2] (and, with ``return_resnorm``, the per-pair
    relative residual of the factorized operator).
    """
    esrc1, edst1, ew1 = (theta_ops[k] for k in
                         ('esrc_1', 'edst_1', 'ew_1'))
    esrc2, edst2, ew2 = (theta_ops[k] for k in
                         ('esrc_2', 'edst_2', 'ew_2'))
    feats_1, feats_2 = theta_ops['feats_1'], theta_ops['feats_2']
    diag = theta_ops['diag']                  # [P, n1, n2]
    precond = theta_ops['precond']
    b = theta_ops['b']
    tol = theta_ops['tol']                    # [P]

    names = sorted(feats_1)
    ranks = _normalize_ranks(ranks, names)
    R = int(np.prod(ranks))
    fused = os.environ.get('GRAPHDOT_KRON_FUSED', '1') != '0'

    P, n1, n2 = diag.shape
    # chunk size: bound the [c, n*R, n] A-stacks (both sides) plus the
    # fused matvec's [c, n1*R, n2] intermediate to ~1.5 GB of device
    # memory.
    if chunk is None:
        budget = int(os.environ.get('GRAPHDOT_KRON_CHUNK_BYTES',
                                    3 << 29))
        chunk = int(max(1, min(
            P, budget // (4 * R * max(n1, n2) ** 2 * 3))))
        # balance the chunks (P=66 at cap 63 should run 2x33, not
        # 63 + 3-real-pairs-plus-60-phantoms)
        chunk = -(-P // (-(-P // chunk)))
    P_pad = -(-P // chunk) * chunk

    axes, grids = _grid_axes(feats_1, feats_2, ew1, ew2, ranks)
    C = _edge_kernel_grid(apply_on_features, kedge, te, grids)
    if fused:
        # the fused path evaluates the basis densely on the (i, j)
        # grid (see _dense_grid_values); it consumes the raw feature
        # columns, not per-edge basis values
        x1s = jnp.stack([feats_1[n] for n in names], axis=-1)
        x2s = jnp.stack([feats_2[n] for n in names], axis=-1)
        side1, side2 = x1s, x2s
    else:
        L1, L2, _ = _grid_basis(feats_1, feats_2, ew1, ew2, ranks)
        side1, side2 = L1, L2

    def _pad(a, fill=0.0):
        return jnp.concatenate(
            [a, jnp.full((P_pad - P, *a.shape[1:]), fill, a.dtype)]
        ) if P_pad != P else a

    def _chunks(a):
        return a.reshape(P_pad // chunk, chunk, *a.shape[1:])

    ops_c = [
        _chunks(_pad(a)) for a in
        (esrc1, edst1, ew1, side1, esrc2, edst2, ew2, side2,
         diag, precond, b)
    ]
    tol_c = _chunks(_pad(tol, fill=1.0))

    def solve_chunk(args):
        (es1, ed1, w1, l1, es2, ed2, w2, l2, dg, pc, bb), tl = args

        dgf = dg.reshape(chunk, n1 * n2)
        pcf = pc.reshape(chunk, n1 * n2)
        bf = bb.reshape(chunk, n1 * n2)

        # float32 contractions at HIGHEST: on a GPU, HIGH would round
        # the operands to TF32, and no operand here is an exact one-hot
        # (see _solver._PRECISION).
        if fused:
            # rank sum fused into two standard batched matmuls via the
            # row-stacked factor layouts (see module docstring): one
            # contraction of depth n1, one of depth R*n2. The factors
            # come from dense-grid basis evaluation; the
            # theta-dependent grid kernel C folds into side 2 with ONE
            # flat [c*n2^2, R] x [R, R] matmul.
            V1 = _dense_grid_values(es1, ed1, w1, l1, n1, names, axes)
            A1s = jnp.transpose(
                V1.reshape(chunk, n1, n1, R), (0, 1, 3, 2)
            ).reshape(chunk, n1 * R, n1)
            V2 = _dense_grid_values(es2, ed2, w2, l2, n2, names, axes)
            V2f = jnp.matmul(
                V2.reshape(chunk * n2 * n2, R), C.T,
                precision=lax.Precision.HIGHEST)
            B2s = jnp.transpose(
                V2f.reshape(chunk, n2, n2, R), (0, 3, 2, 1)
            ).reshape(chunk, R * n2, n2)
            # materialize the (transposed) factors once, outside the
            # CG while-loop: without the barrier XLA may fuse the
            # transposes into the loop body and re-lay them out every
            # iteration
            A1s, B2s = lax.optimization_barrier((A1s, B2s))

            def matvec(yf):
                Y = yf.reshape(chunk, n1, n2)
                G = lax.dot_general(
                    A1s, Y, (((2,), (1,)), ((0,), (0,))),
                    precision=lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)
                G = G.reshape(chunk, n1, R * n2)
                O = lax.dot_general(
                    G, B2s, (((2,), (1,)), ((0,), (0,))),
                    precision=lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)
                return dgf * yf - O.reshape(chunk, n1 * n2)
        else:
            # sequential rank loop (kept for A/B and as a compiler
            # fallback): a static Python loop of standard batched
            # matmuls, per-term intermediate [c, n1, n2]; the grid
            # kernel folds into the per-edge side-2 basis pre-scatter
            l2c = jnp.einsum('cmq,pq->cmp', l2, C,
                             precision=lax.Precision.HIGHEST)
            A1 = _assemble_stack(es1, ed1, w1, l1, n1)
            B2 = _assemble_stack(es2, ed2, w2, l2c, n2)

            def matvec(yf):
                Y = yf.reshape(chunk, n1, n2)
                out = dgf * yf
                for r in range(R):
                    G = jnp.einsum(
                        'cij,cjk->cik', A1[:, r], Y,
                        precision=lax.Precision.HIGHEST,
                        preferred_element_type=jnp.float32)
                    O = jnp.einsum(
                        'cik,clk->cil', G, B2[:, r],
                        precision=lax.Precision.HIGHEST,
                        preferred_element_type=jnp.float32)
                    out = out - O.reshape(chunk, n1 * n2)
                return out

        if return_iters:
            from ._solver import pcg
            xf, iters = pcg(matvec, bf, pcf, tl, maxiter,
                            return_iters=True)
            return xf.reshape(chunk, n1, n2), iters
        xf = solve_linear(matvec, bf, pcf, tl, maxiter)
        if return_resnorm:
            leftover = jnp.linalg.norm(bf - matvec(xf), axis=-1)
            scale = jnp.linalg.norm(bf, axis=-1)
            rel = leftover / jnp.where(scale > 0, scale, 1.0)
            return xf.reshape(chunk, n1, n2), rel
        return xf.reshape(chunk, n1, n2)

    # Python loop over chunks, unrolled at trace time: a flat sequence
    # of chunk solves in one program, each with its own CG loop.
    # n_chunks is small (typically 1-8), so program-size growth is
    # bounded.
    outs = [
        solve_chunk((tuple(a[i] for a in ops_c), tol_c[i]))
        for i in range(P_pad // chunk)
    ]
    if return_resnorm or return_iters:
        xs = jnp.concatenate([o[0] for o in outs])
        aux = jnp.concatenate([o[1] for o in outs])
        return xs[:P], aux[:P]
    return jnp.concatenate(outs)[:P]
