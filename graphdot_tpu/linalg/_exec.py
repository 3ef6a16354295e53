"""Execution policy for host-facing dense linear algebra.

Every decomposition in :mod:`graphdot_tpu.linalg` runs through JAX so one
code path serves both float32 (the solver's production precision) and
float64 (what the sklearn-style model API defaults to, since its
closed-form LOOCV / likelihood identities assume double precision).

Float64 inputs are executed under a scoped ``jax.enable_x64()`` on the
default device; a device that cannot run them raises. No global
configuration is touched.
"""
import numpy as np
import jax
import jax.numpy as jnp


def run(fn, *arrays):
    """Run a jitted array function at the precision of its inputs.

    float64 inputs execute under ``enable_x64``; everything else runs
    with default (float32) semantics. Both run on the default device.
    Outputs are returned as numpy arrays.
    """
    arrays = [np.asarray(a) for a in arrays]
    if any(a.dtype == np.float64 for a in arrays):
        with jax.enable_x64():
            out = fn(*map(jnp.asarray, arrays))
            return jax.tree_util.tree_map(np.asarray, out)
    out = fn(*map(jnp.asarray, arrays))
    return jax.tree_util.tree_map(np.asarray, out)


# ---------------------------------------------------------------------
# jitted decomposition primitives
# ---------------------------------------------------------------------

@jax.jit
def _eigh(H):
    return jnp.linalg.eigh(H)


@jax.jit
def _cholesky(A):
    return jnp.linalg.cholesky(A)


@jax.jit
def _cho_apply(L, B):
    return jax.scipy.linalg.cho_solve((L, True), B)


@jax.jit
def _svd(X):
    return jnp.linalg.svd(X, full_matrices=False)


def eigh(H):
    """Ascending eigendecomposition of a Hermitian matrix (numpy out)."""
    return run(_eigh, H)


def cholesky(A):
    """Lower Cholesky factor; NaN-filled where A is not PD (numpy out)."""
    return run(_cholesky, A)


def cho_apply(L, B):
    """Solve ``A x = B`` given the lower Cholesky factor of A."""
    return run(_cho_apply, L, B)


def svd(X):
    """Thin SVD (U, s, Vt) as numpy arrays."""
    return run(_svd, X)
