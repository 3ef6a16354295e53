"""Factored ("low-rank") matrix algebra.

Fills the role of the reference's lazy low-rank classes
(``graphdot/linalg/low_rank.py:51-283``) with a different architecture:

* One uniform container, :class:`Factored`, holds a square matrix as a
  *sum of tall-skinny products* ``sum_k L_k @ R_k``. Addition,
  subtraction, transposition and composition all stay in this form, so
  Nystrom-style models never materialize an N-by-N matrix.
* The symmetric PSD case is :class:`Spectral`, which stores an
  orthonormal basis and per-direction weights ``(U, s)`` representing
  ``U diag(s^2) U^T``; pseudoinverse / logdet / powers act on ``s``.
* Dense decompositions (SVD) run on the accelerator via
  :mod:`graphdot_tpu.linalg._exec`; the regularized ``pinvh`` uses
  matrix-free randomized subspace iteration (all matmuls, accelerator-friendly)
  instead of the reference's host-serial ARPACK Lanczos.
"""
import numpy as np

from ._exec import svd as _device_svd


def _terms_of(other):
    if isinstance(other, Factored):
        return other.terms
    raise TypeError(f'Cannot combine Factored with {type(other)}.')


class Factored:
    """A square matrix held as ``sum_k L_k @ R_k``.

    ``terms`` is a sequence of (L, R) pairs with shapes (n, k_i) and
    (k_i, n).
    """

    def __init__(self, terms):
        self.terms = [(np.asarray(L), np.asarray(R)) for L, R in terms]

    def __repr__(self):
        return ' + '.join(
            f'[{L.shape[0]}x{L.shape[1]} @ {R.shape[0]}x{R.shape[1]}]'
            for L, R in self.terms
        )

    # -- linear structure ------------------------------------------------

    @property
    def T(self):
        return Factored([(R.T, L.T) for L, R in self.terms])

    def __neg__(self):
        return Factored([(-L, R) for L, R in self.terms])

    def __add__(self, other):
        return Factored(self.terms + _terms_of(other))

    def __sub__(self, other):
        return Factored(self.terms + (-other).terms)

    def __matmul__(self, other):
        if isinstance(other, Factored):
            # contract through the small k x k inner blocks
            return Factored([
                (La @ (Ra @ Lb), Rb)
                for La, Ra in self.terms for Lb, Rb in other.terms
            ])
        other = np.asarray(other)
        out = 0
        for L, R in self.terms:
            out = out + L @ (R @ other)
        return out

    # -- reductions (never materialize n x n) ----------------------------

    def diagonal(self):
        return sum(
            np.einsum('ik,ki->i', L, R) for L, R in self.terms
        )

    def trace(self):
        return self.diagonal().sum()

    def quadratic(self, a, b):
        """``a @ M @ b`` without forming M."""
        return sum((a @ L) @ (R @ b) for L, R in self.terms)

    def quadratic_diag(self, a, b):
        """``diag(a @ M @ b)`` without forming M."""
        return sum(
            np.einsum('ik,ki->i', a @ L, R @ b) for L, R in self.terms
        )

    def todense(self):
        return sum(L @ R for L, R in self.terms)


class Spectral(Factored):
    """Symmetric PSD factored matrix ``U diag(s^2) U^T``.

    ``U`` is column-orthonormal; ``s`` carries the square roots of the
    eigenvalues, so ``root = U * s`` satisfies ``M = root @ root.T``.
    """

    def __init__(self, U, s):
        self.U = np.asarray(U)
        self.s = np.asarray(s)

    @classmethod
    def from_root(cls, X, rcond=0, mode='truncate'):
        """Spectral form of ``X @ X.T`` from the SVD of X, filtering
        singular values below ``rcond * max`` ('truncate' drops them,
        'clamp' raises them to the cutoff)."""
        U, s, _ = _device_svd(X)
        floor = s[0] * rcond
        if mode == 'truncate':
            keep = s >= floor
            U, s = U[:, keep], s[keep]
        elif mode == 'clamp':
            s = np.maximum(s, floor)
        else:
            raise RuntimeError(
                f"Unknown spectral approximation mode '{mode}'.")
        return cls(U, s)

    @property
    def root(self):
        return self.U * self.s

    @property
    def terms(self):
        root = self.root
        return [(root, root.T)]

    @property
    def T(self):
        return self

    def diagonal(self):
        return np.einsum('ik,ik->i', self.root, self.root)

    def pinv(self):
        return Spectral(self.U, 1.0 / self.s)

    def logdet(self):
        return 2.0 * float(np.sum(np.log(self.s)))

    def cond(self):
        return float((self.s.max() / self.s.min()) ** 2)

    def __pow__(self, exponent):
        return Spectral(self.U, self.s ** exponent)


def dot(X, Y=None, method='auto', rcond=0, mode='truncate'):
    """Factored matrix ``X @ Y`` (two factors) or ``X @ X.T`` through a
    spectral decomposition (Y omitted)."""
    if Y is None:
        if method == 'direct':
            return Factored([(X, X.T)])
        return Spectral.from_root(X, rcond=rcond, mode=mode)
    if method == 'spectral':
        raise RuntimeError(
            'The spectral form requires a symmetric product (Y=None).')
    return Factored([(X, Y)])


def pinvh(A, d, k='auto', rcond=1e-10, mode='truncate', n_iter=32,
          seed=0):
    """Pseudoinverse of ``A + diag(d)`` (A factored PSD) as a
    :class:`Spectral`, keeping the top-k eigenspace.

    Matrix-free randomized subspace iteration: every step is a tall
    matmul through A's factors plus a diagonal scaling — O(n k (r + k))
    per sweep and accelerator-friendly, in contrast to the reference's
    sequential ARPACK Lanczos (``low_rank.py:214-283``).
    """
    n = len(d)
    if k == 'auto':
        k = min(n, sum(L.shape[1] for L, _ in A.terms)
                + int(np.count_nonzero(d)))
    assert isinstance(k, (int, np.integer)) and 0 < k <= n

    def apply(V):
        return A @ V + d[:, None] * V

    rng = np.random.default_rng(seed)
    V = np.linalg.qr(rng.standard_normal((n, k)))[0]
    for _ in range(n_iter):
        V = np.linalg.qr(apply(V))[0]
    # Rayleigh-Ritz on the converged subspace
    T = V.T @ apply(V)
    w, S = np.linalg.eigh((T + T.T) / 2)
    w, Q = w[::-1], (V @ S)[:, ::-1]

    floor = w[0] * rcond
    above = w > floor
    if mode == 'truncate':
        w, Q = w[above], Q[:, above]
    elif mode == 'clamp':
        w = np.where(above, w, floor)
    else:
        raise RuntimeError(f"Unknown pseudoinverse mode '{mode}'.")
    return Spectral(Q, w ** -0.5)


# compatibility aliases for the reference's class names
def LATR(lhs, rhs):
    return Factored([(lhs, rhs)])


def LLT(X, rcond=0, mode='truncate'):
    if isinstance(X, tuple):
        return Spectral(*X)
    return Spectral.from_root(X, rcond=rcond, mode=mode)
