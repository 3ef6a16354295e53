"""Batched product-graph MLGK solver.

Replaces the reference CUDA solver
(``graphdot/cpp/marginalized_kernel.h:189-490`` and
``graphdot/kernel/marginalized/template.cu:29``) with a batched,
Jacobi-preconditioned conjugate-gradient solve expressed in JAX:

- The per-pair linear system is the same generalized Kronecker system as
  the CPU oracle (``test/kernel/marginalized/test_kernel.py:20-68``):
  ``[diag(Dx/Vx) - (A1 (x) A2) . Ex] x = Dx`` with
  ``Dx = kron(D1, D2)/(1-q)^2`` and the kernel value
  ``K = sum_ij p1_i p2_j x_ij`` (q0 == q in the reference backend, so the
  ``q^2/q0^2`` right-hand-side factor is identically 1).

- Instead of on-the-fly sparse octile expansion, the off-diagonal matvec
  is either (a) a dense precomputed coupling tensor (``mode='dense'``)
  or (b) an edge-factored form
  ``S1 (T o (D1 Y D2^T)) S2^T`` with per-pair edge-kernel matrix
  ``T[e1,e2] = w1 w2 k_edge(e1,e2)`` and one-hot incidence matrices, i.e.
  four batched contractions per CG iteration (``mode='edge'``), run
  either by XLA or by the fused kernel of ``ops/pallas_pcg.py``
  (``mode='pallas'``).

- Instead of a dual-RHS adjoint solve (``compute_duo``,
  ``marginalized_kernel.h:492-804``) and finite-difference theta grids
  (``template.cu:286-418``), gradients flow through
  ``lax.custom_linear_solve`` via the implicit function theorem — exact
  for every hyperparameter, nodal or not.

All pairs in a batch are solved simultaneously with static shapes; a
``lax.while_loop`` with per-pair convergence masks handles the
data-dependent iteration counts (stop at ``sqrt(rTr) < ftol*N``, max N
iterations, mirroring ``marginalized_kernel.h:449``).
"""
import jax
import jax.numpy as jnp
from jax import lax

from ...ops.pallas_pcg import fits, fused_pcg_solver

# CG runs in float32 and the XLA solver's contractions at HIGHEST. On a
# GPU, HIGH and DEFAULT let XLA round float32 operands to TF32 (10
# mantissa bits). Every matvec contraction has an exact 0/1 operand, but
# the other one (the CG direction and its images) is rounded: on an H100,
# HIGH stays within rel 1e-4 of the float64 oracle on molecules (7.3e-5)
# but not within the 1e-5 that the fused kernel meets, and on the GPU
# this solver runs the protein-scale pairs, where no oracle checks it
# (PERF.md, Findings). The fused kernel keeps its own 2-pass TF32 split
# (``ops/pallas_pcg.py``). Switchable for measurement
# (scripts/compare_solvers.py).
_PRECISIONS = {
    'default': lax.Precision.DEFAULT,
    'high': lax.Precision.HIGH,
    'highest': lax.Precision.HIGHEST,
}
_PRECISION = lax.Precision.HIGHEST


def set_solver_precision(name):
    """Set the precision of the XLA solver's contractions ('default',
    'high', 'highest'). Takes effect on the next trace."""
    global _PRECISION
    _PRECISION = _PRECISIONS[name]


def _einsum(*args):
    return jnp.einsum(
        *args, precision=_PRECISION, preferred_element_type=jnp.float32
    )

# ---------------------------------------------------------------------------
# feature pytree helpers
# ---------------------------------------------------------------------------


def _expand(feat, axes):
    """Insert broadcast axes into a feature (array or (values, mask))."""
    if isinstance(feat, tuple):
        v, m = feat
        for ax in axes:
            v = jnp.expand_dims(v, ax)
            m = jnp.expand_dims(m, ax)
        return (v, m)
    for ax in axes:
        feat = jnp.expand_dims(feat, ax)
    return feat


def _expand_dict(feats, axes):
    return {k: _expand(v, axes) for k, v in feats.items()}


def _apply_on_features(kernel, theta, X, Y):
    """Recursively evaluate ``kernel`` on dict features: composites index
    the dict themselves; elementary kernels are fed the single column."""
    name = kernel.name
    if name == 'Composite':
        return kernel.apply(theta, X, Y)
    if name == 'Normalize':
        Fxy = _apply_on_features(kernel.kernel, theta, X, Y)
        Fxx = _apply_on_features(kernel.kernel, theta, X, X)
        Fyy = _apply_on_features(kernel.kernel, theta, Y, Y)
        den = jnp.sqrt(Fxx * Fyy)
        ok = den > 0
        return jnp.where(ok, Fxy / jnp.where(ok, den, 1.0), 0.0)
    if name in ('Add', 'Multiply', 'Exponentiation'):
        n1 = kernel.k1.n_theta
        f1 = _apply_on_features(kernel.k1, theta[:n1], X, Y)
        f2 = _apply_on_features(
            kernel.k2, theta[n1:kernel.n_theta], X, Y
        )
        if name == 'Add':
            return f1 + f2
        elif name == 'Multiply':
            return f1 * f2
        else:
            return f1 ** f2
    # elementary kernel on a single feature column
    if isinstance(X, dict):
        if len(X) == 1:
            (x,) = X.values()
            (y,) = Y.values()
            return kernel.apply(theta, x, y)
        elif kernel.n_theta > 0 and kernel.name == 'Constant':
            # Constant ignores features; use any column for shape
            x = next(iter(X.values()))
            y = next(iter(Y.values()))
            return kernel.apply(theta, x, y)
        else:
            raise ValueError(
                f'Elementary kernel {kernel.name} cannot consume '
                f'multi-column features {list(X)}; wrap it in '
                'TensorProduct/Additive.'
            )
    return kernel.apply(theta, X, Y)


# ---------------------------------------------------------------------------
# batched preconditioned CG with implicit differentiation
# ---------------------------------------------------------------------------


def _batch_dot(a, b):
    return jnp.sum(a * b, axis=-1)


def pcg(matvec, b, precond, tol, maxiter, return_iters=False):
    """Batched Jacobi-PCG. All operands [P, N]; ``tol`` [P] is the absolute
    residual-norm threshold per pair (reference uses ftol * N).

    With ``return_iters`` (static), also returns the per-pair iteration
    count at which each system converged (``maxiter`` for systems the cap
    preempted) — the instrument behind the benches' FLOP/MFU accounting.
    """

    z0 = precond * b
    rr0 = _batch_dot(b, b)
    done0 = jnp.sqrt(rr0) < tol
    state0 = (
        jnp.zeros_like(b),   # x
        b,                   # r
        z0,                  # p
        _batch_dot(b, z0),   # rz
        done0,
        jnp.int32(0),
        jnp.where(done0, 0, maxiter).astype(jnp.int32),   # per-pair iters
    )

    def cond(state):
        done, it = state[4], state[5]
        return (it < maxiter) & jnp.any(~done)

    def body(state):
        x, r, p, rz, done, it, iters = state
        Ap = matvec(p)
        pAp = _batch_dot(p, Ap)
        bad = (pAp == 0.0) | (rz == 0.0)
        step = ~(done | bad)
        alpha = jnp.where(step, rz / jnp.where(pAp == 0, 1.0, pAp), 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = precond * r
        rz_new = _batch_dot(r, z)
        rr = _batch_dot(r, r)
        done_new = done | bad | (jnp.sqrt(rr) < tol)
        beta = jnp.where(
            done_new, 0.0, rz_new / jnp.where(rz == 0, 1.0, rz)
        )
        p = z + beta[:, None] * p
        rz = jnp.where(done_new, rz, rz_new)
        iters = jnp.where(done_new & ~done, it + 1, iters)
        return (x, r, p, rz, done_new, it + 1, iters)

    x, _, _, _, _, _, iters = lax.while_loop(cond, body, state0)
    if return_iters:
        return x, iters
    return x


def solve_linear(matvec, b, precond, tol, maxiter, solve_impl=None):
    """Solve the symmetric product-graph system with implicit-function
    gradients (the analogue of the reference's analytic adjoint path,
    ``marginalized_kernel.h:492-997``).

    ``solve_impl`` optionally overrides the primal/tangent solver (e.g.
    the fused Pallas PCG); the XLA matvec is still what gets
    differentiated.
    """
    if solve_impl is None:
        def solve_impl(bb):
            return pcg(matvec, bb, precond, tol, maxiter)
    return lax.custom_linear_solve(
        matvec, b,
        solve=lambda mv, bb: solve_impl(bb),
        symmetric=True,
    )


# ---------------------------------------------------------------------------
# the batched MLGK solve
# ---------------------------------------------------------------------------


def mlgk_solve(theta, ops, *, knode, kedge, n_p_theta, lmin, mode,
               maxiter, kron_ranks=None, return_resnorm=False,
               return_iters=False):
    """Solve a batch of graph-pair MLGK systems.

    Parameters
    ----------
    theta: [n_dims] linear-scale hyperparameters laid out as
        [p..., q, node_theta..., edge_theta...] (reference layout,
        ``_kernel.py:430-440``).
    ops: dict of per-side operands (see ``_make_operands`` in the host
        kernel class). All leading dims are the number of jobs P.
    knode, kedge: microkernels (static).
    n_p_theta: number of starting-probability hyperparameters (static).
    lmin: 0 or 1 (static).
    mode: 'dense', 'edge', 'pallas' or 'kron' (static).
    maxiter: static int bound on CG iterations.
    return_resnorm: static bool; when True, also return the per-pair
        final *relative* residual ||b - A x|| / ||b||. Converged f32
        solves sit near 1e-7..1e-5 (epsilon times conditioning);
        values orders of magnitude above that baseline mean the
        ``maxiter`` cap preempted convergence — the non-convergence
        signal for bounded-effort inference solves.

    Returns
    -------
    x: [P, n1, n2] solution of the product-graph system (zero on padding)
    Vx: [P, n1, n2] node-kernel diagonal
    valid: [P, n1, n2] product-space validity mask
    resnorm_ratio: [P] (only when ``return_resnorm``)
    """
    q = theta[n_p_theta]
    tn = theta[n_p_theta + 1:n_p_theta + 1 + knode.n_theta]
    te = theta[n_p_theta + 1 + knode.n_theta:
               n_p_theta + 1 + knode.n_theta + kedge.n_theta]

    nf1, nf2 = ops['node_feats_1'], ops['node_feats_2']
    mask1, mask2 = ops['node_mask_1'], ops['node_mask_2']
    deg1, deg2 = ops['degree_1'], ops['degree_2']

    P, n1 = mask1.shape
    n2 = mask2.shape[1]
    N = n1 * n2

    if not nf1:
        # unlabeled graphs: synthesize a constant feature for shape
        nf1 = {'_phantom': mask1}
        nf2 = {'_phantom': mask2}

    # Vx[i1, i2] = k_node(f1_i1, f2_i2)
    Vx = _apply_on_features(
        knode, tn,
        _expand_dict(nf1, (2,)),   # [P, n1, 1(, L)]
        _expand_dict(nf2, (1,)),   # [P, 1, n2(, L)]
    )
    Vx = jnp.broadcast_to(Vx, (P, n1, n2))

    valid = mask1[:, :, None] * mask2[:, None, :]
    dx = (deg1[:, :, None] * deg2[:, None, :]) / (1.0 - q) ** 2

    ok = (valid > 0) & (dx > 0) & (Vx > 0)
    diag_coef = jnp.where(ok, dx / jnp.where(ok, Vx, 1.0), 1.0)
    precond_diag = jnp.where(ok, Vx / jnp.where(ok, dx, 1.0), 1.0)
    b = jnp.where(ok, dx, 0.0)

    if mode == 'kron':
        from ._kron import kron_mlgk_solve
        if 'tol_n1' in ops:
            n_true = ops['tol_n1'] * ops['tol_n2']
        else:
            n_true = jnp.sum(mask1, axis=1) * jnp.sum(mask2, axis=1)
        theta_ops = {
            'esrc_1': ops['esrc_1'], 'edst_1': ops['edst_1'],
            'ew_1': ops['ew_1'],
            'esrc_2': ops['esrc_2'], 'edst_2': ops['edst_2'],
            'ew_2': ops['ew_2'],
            'feats_1': dict(ops['edge_elist_feats_1']),
            'feats_2': dict(ops['edge_elist_feats_2']),
            'diag': diag_coef, 'precond': precond_diag, 'b': b,
            'tol': ops['ftol'] * n_true,
        }
        out = kron_mlgk_solve(
            theta_ops, apply_on_features=_apply_on_features,
            kedge=kedge, te=te, ranks=kron_ranks,
            maxiter=maxiter, solve_linear=solve_linear,
            return_resnorm=return_resnorm,
            return_iters=return_iters,
        )
        if return_resnorm or return_iters:
            x, aux = out
        else:
            x = out
        if lmin == 1:
            x = x - jnp.where(valid > 0, Vx, 0.0)
        if return_resnorm or return_iters:
            return x, Vx, valid, aux
        return x, Vx, valid

    if mode == 'dense':
        adj1, adj2 = ops['adj_1'], ops['adj_2']
        raw_ef1, raw_ef2 = ops['edge_feats_1'], ops['edge_feats_2']
        if not raw_ef1:
            raw_ef1 = {'_phantom': adj1}
            raw_ef2 = {'_phantom': adj2}
        ef1 = _expand_dict(raw_ef1, (3, 4))  # [P,n1,n1,1,1(,L)]
        ef2 = _expand_dict(raw_ef2, (1, 2))  # [P,1,1,n2,n2(,L)]
        ke = _apply_on_features(kedge, te, ef1, ef2)
        # W[c, i1, j1, i2, j2]
        W = (ke * adj1[:, :, :, None, None] * adj2[:, None, None, :, :])
        W = jnp.broadcast_to(W, (P, n1, n1, n2, n2))

        def offdiag(Y):
            return _einsum('cijkl,cjl->cik', W, Y)
    else:
        esrc1, edst1, ew1 = ops['esrc_1'], ops['edst_1'], ops['ew_1']
        esrc2, edst2, ew2 = ops['esrc_2'], ops['edst_2'], ops['ew_2']
        raw_eef1 = ops['edge_elist_feats_1']
        raw_eef2 = ops['edge_elist_feats_2']
        if not raw_eef1:
            raw_eef1 = {'_phantom': ew1}
            raw_eef2 = {'_phantom': ew2}
        eef1 = _expand_dict(raw_eef1, (2,))  # [P,M1,1(,L)]
        eef2 = _expand_dict(raw_eef2, (1,))  # [P,1,M2(,L)]
        ke = _apply_on_features(kedge, te, eef1, eef2)
        T = ke * ew1[:, :, None] * ew2[:, None, :]  # [P, M1, M2]
        M1 = esrc1.shape[1]
        M2 = esrc2.shape[1]
        T = jnp.broadcast_to(T, (P, M1, M2))
        # one-hot incidence matrices -> all-matmul matvec. They are
        # theta-independent; callers that evaluate many thetas over a
        # fixed graph set (GramFactory) pass them in precomputed.
        if 'oh_src_1' in ops:
            oh_src1 = ops['oh_src_1']
            oh_dst1 = ops['oh_dst_1']
            oh_src2 = ops['oh_src_2']
            oh_dst2 = ops['oh_dst_2']
        else:
            oh_src1 = jax.nn.one_hot(esrc1, n1, dtype=jnp.float32)
            oh_dst1 = jax.nn.one_hot(edst1, n1, dtype=jnp.float32)
            oh_src2 = jax.nn.one_hot(esrc2, n2, dtype=jnp.float32)
            oh_dst2 = jax.nn.one_hot(edst2, n2, dtype=jnp.float32)

        def offdiag(Y):
            G = _einsum('cen,cnk->cek', oh_dst1, Y)
            H = _einsum('cek,cfk->cef', G, oh_dst2)
            Z = T * H
            U = _einsum('cef,cei->cif', Z, oh_src1)
            return _einsum('cif,cfk->cik', U, oh_src2)

    diag_flat = diag_coef.reshape(P, N)
    precond_flat = precond_diag.reshape(P, N)
    b_flat = b.reshape(P, N)

    def matvec(y):
        Y = y.reshape(P, n1, n2)
        out = diag_flat * y - offdiag(Y).reshape(P, N)
        return out

    if 'tol_n1' in ops:
        # union-packed batches (cross-product pair packing): the
        # per-system tolerance must guarantee EVERY member pair its own
        # ftol * n1 * n2 bound, so the caller passes the min member
        # node counts per side (min_i n1_i * min_j n2_j = min over the
        # tile, all counts positive). For plain pairs these equal the
        # pair's own node counts and the formula reduces to the
        # reference's ftol * N (marginalized_kernel.h:449).
        n_true = ops['tol_n1'] * ops['tol_n2']
    else:
        n_true = jnp.sum(mask1, axis=1) * jnp.sum(mask2, axis=1)
    tol = ops['ftol'] * n_true

    if return_iters:
        # diagnostic path (FLOP/MFU accounting): run the XLA PCG with
        # per-pair iteration counting; no gradient support needed.
        x_flat, iters = pcg(
            matvec, b_flat, precond_flat, tol, maxiter,
            return_iters=True)
        x = x_flat.reshape(P, n1, n2)
        if lmin == 1:
            x = x - jnp.where(valid > 0, Vx, 0.0)
        return x, Vx, valid, iters

    solve_impl = None
    if mode == 'pallas' and fits(
            esrc1.shape[1], esrc2.shape[1], n1, n2):
        # primal, tangent and transpose solves run in the fused kernel;
        # the XLA matvec above is what autodiff differentiates. Bigger
        # pairs keep the XLA solve (the size rule in pallas_pcg.fits).
        solve_impl = fused_pcg_solver(
            T, esrc1, edst1, esrc2, edst2, diag_coef, precond_diag, tol,
            maxiter)

    x_flat = solve_linear(
        matvec, b_flat, precond_flat, tol, maxiter,
        solve_impl=solve_impl
    )
    x = x_flat.reshape(P, n1, n2)

    if lmin == 1:
        # skip the l=0 term of the random-walk sum (template.cu:135-141)
        x = x - jnp.where(valid > 0, Vx, 0.0)

    if return_resnorm:
        leftover = jnp.linalg.norm(b_flat - matvec(x_flat), axis=-1)
        scale = jnp.linalg.norm(b_flat, axis=-1)
        rel = leftover / jnp.where(scale > 0, scale, 1.0)
        return x, Vx, valid, rel
    return x, Vx, valid


def weight_by_p(x, p1, p2):
    """R[i1, i2] = x[i1, i2] * p1_i1 * p2_i2 (template.cu:153)."""
    return x * p1[:, :, None] * p2[:, None, :]
