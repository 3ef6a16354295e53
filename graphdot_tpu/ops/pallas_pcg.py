"""Fused product-graph Jacobi-PCG for NVIDIA GPUs (Pallas, Triton route).

The counterpart of the reference's one-block-per-pair CUDA solver
(``graphdot/cpp/marginalized_kernel.h:189-490``): one Pallas program per
(union-packed) pair runs that pair's whole CG loop on chip and exits as
soon as the pair converges, so no pair iterates for the slowest one in
its batch and no iteration round-trips through device memory. The
reference expands the product-graph matvec from adjacency octiles in
shared memory; here it is the edge-factored form of the XLA ``edge``
solver,

    out = diag * Y - S1^T (T o (D1 Y D2^T)) S2,

four ``pl.dot`` contractions per iteration against incidence one-hots
that the program builds from the edge index lists (``S``/``D`` never
leave the chip). Every dimension is padded to a power of two >= 16, the
shapes Triton's ``dot`` takes.

Precision: every contraction has a 0/1 one-hot operand, exact in TF32,
so only the other operand needs more than TF32's 10 mantissa bits. It is
split into a TF32-exact high part (low 13 mantissa bits cleared) and the
remainder, and each goes through one TF32 tensor-core product: about
float32 accuracy at two passes. On an H100 one TF32 pass missed the
float64 oracle's rel 1e-4, and Triton's 3-pass ``tf32x3`` and CUDA-core
float32 were slower (``PERF.md``, Findings).
"""
import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: shared memory one thread block may use on Hopper (H100 / H200)
SMEM_BYTES = 227 * 1024


def _pow2(d):
    return max(16, 1 << (int(d) - 1).bit_length())


def fused_bytes(M1, M2, N1, N2):
    """On-chip working set of one program at the padded dims: T and the
    Hadamard product (M1 x M2), the four one-hots, the two matvec
    intermediates and eight product-space CG vectors."""
    M1, M2, N1, N2 = map(_pow2, (M1, M2, N1, N2))
    return 4 * (2 * M1 * M2 + 2 * M1 * N1 + 2 * M2 * N2
                + M1 * N2 + N1 * M2 + 8 * N1 * N2)


def fits(M1, M2, N1, N2):
    """The size rule for the fused kernel: a pair whose working set
    exceeds one block's shared memory takes the XLA ``edge`` solver."""
    return fused_bytes(M1, M2, N1, N2) <= SMEM_BYTES


def _tf32_hi(x):
    bits = lax.bitcast_convert_type(x, jnp.int32)
    return lax.bitcast_convert_type(bits & jnp.int32(-8192), jnp.float32)


def _dot(a, b, trans_a, trans_b, general):
    """``a @ b`` (optionally transposed) in two TF32 passes, where
    operand ``general`` (0 or 1) is the non-one-hot side."""
    x = (a, b)[general]
    hi = _tf32_hi(x)
    parts = [(hi, b) if general == 0 else (a, hi),
             (x - hi, b) if general == 0 else (a, x - hi)]
    return sum(pl.dot(p, q, trans_a, trans_b,
                      precision=lax.Precision.DEFAULT)
               for p, q in parts)


def _one_hot(idx, n):
    cols = lax.broadcasted_iota(jnp.int32, (idx.shape[0], n), 1)
    return (idx[:, None] == cols).astype(jnp.float32)


def _pcg_kernel(T_ref, s1_ref, d1_ref, s2_ref, d2_ref, diag_ref, pc_ref,
                b_ref, tol_ref, x_ref, *, maxiter):
    T = T_ref[...]
    diag = diag_ref[...]
    precond = pc_ref[...]
    b = b_ref[...]
    tol = jnp.sum(tol_ref[...])
    N1, N2 = diag.shape
    S1 = _one_hot(s1_ref[...], N1)
    D1 = _one_hot(d1_ref[...], N1)
    S2 = _one_hot(s2_ref[...], N2)
    D2 = _one_hot(d2_ref[...], N2)

    def matvec(y):
        G = _dot(D1, y, False, False, 1)         # [M1, N2]
        H = _dot(G, D2, False, True, 0)          # [M1, M2]
        U = _dot(S1, T * H, True, False, 1)      # [N1, M2]
        return diag * y - _dot(U, S2, False, False, 0)

    z0 = precond * b
    rz0 = jnp.sum(b * z0)
    state0 = (jnp.zeros_like(b), b, z0, rz0,
              jnp.sqrt(jnp.sum(b * b)) < tol, jnp.int32(0))

    def cond(state):
        done, it = state[4], state[5]
        return jnp.logical_and(it < maxiter, jnp.logical_not(done))

    def body(state):
        x, r, p, rz, _, it = state
        Ap = matvec(p)
        pAp = jnp.sum(p * Ap)
        bad = jnp.logical_or(pAp == 0.0, rz == 0.0)
        alpha = jnp.where(bad, 0.0, rz / jnp.where(pAp == 0.0, 1.0, pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond * r
        rz_new = jnp.sum(r * z)
        done = jnp.logical_or(bad, jnp.sqrt(jnp.sum(r * r)) < tol)
        beta = rz_new / jnp.where(rz == 0.0, 1.0, rz)
        return x, r, z + beta * p, rz_new, done, it + 1

    x_ref[...] = lax.while_loop(cond, body, state0)[0]


@functools.partial(jax.jit, static_argnames=('maxiter',))
def fused_pcg(T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol,
              maxiter):
    """Solve a batch of product-graph systems, one program per pair.

    Parameters
    ----------
    T: [P, M1, M2] edge-coupling matrices (zero on padded edges).
    esrc1, edst1: [P, M1] int32 edge endpoints of side 1 (< N1).
    esrc2, edst2: [P, M2] int32 edge endpoints of side 2 (< N2).
    diag, precond, b: [P, N1, N2] diagonal coefficient, Jacobi
        preconditioner and right-hand side.
    tol: [P] absolute residual-norm thresholds.
    maxiter: static CG iteration bound.

    Returns
    -------
    x: [P, N1, N2]
    """
    P, M1, M2 = T.shape
    N1, N2 = diag.shape[1:]
    pM1, pM2, pN1, pN2 = map(_pow2, (M1, M2, N1, N2))

    def pad(a, *dims, value=0):
        return jnp.pad(a, [(0, 0)] + [(0, d - s) for d, s in
                                      zip(dims, a.shape[1:])],
                       constant_values=value)

    operands = (
        pad(T, pM1, pM2),
        pad(esrc1, pM1), pad(edst1, pM1),
        pad(esrc2, pM2), pad(edst2, pM2),
        pad(diag, pN1, pN2, value=1.0), pad(precond, pN1, pN2, value=1.0),
        pad(b, pN1, pN2),
        tol.reshape(P, 1).astype(jnp.float32),
    )

    def spec(*shape):
        return pl.BlockSpec((None, *shape),
                            lambda i: (i,) + (0,) * len(shape))

    x = pl.pallas_call(
        functools.partial(_pcg_kernel, maxiter=maxiter),
        grid=(P,),
        in_specs=[
            spec(pM1, pM2),
            spec(pM1), spec(pM1), spec(pM2), spec(pM2),
            spec(pN1, pN2), spec(pN1, pN2), spec(pN1, pN2),
            spec(1),
        ],
        out_specs=spec(pN1, pN2),
        out_shape=jax.ShapeDtypeStruct((P, pN1, pN2), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend='triton',
        name='graphdot_fused_pcg',
    )(*operands)
    return x[:, :N1, :N2]


def fused_pcg_solver(T, esrc1, edst1, esrc2, edst2, diag, precond, tol,
                     maxiter):
    """A ``solve(b_flat)`` closure over the system operands, for use as
    the primal, tangent and transpose solver inside
    ``lax.custom_linear_solve``. ``b_flat`` is [P, N1 * N2]."""
    P = T.shape[0]
    N1, N2 = diag.shape[1:]

    def solve(b_flat):
        x = fused_pcg(T, esrc1, edst1, esrc2, edst2, diag, precond,
                      b_flat.reshape(P, N1, N2), tol, maxiter=maxiter)
        return x.reshape(P, N1 * N2)

    return solve
