"""Standalone RBF kernel over vector data (fills the role of the
reference's ``graphdot/kernel/rbf.py:11``), in JAX: the pairwise
distance matrix and the kernel map run on device as one jitted function,
and hyperparameter gradients come from ``jax.jacfwd`` instead of
symbolic per-parameter differentiation."""
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import sympy
from sympy.utilities.lambdify import lambdify

from ..linalg._exec import run


def _pairwise_dist(X, Y):
    """Euclidean cdist with a branch-free clamped sqrt (safe under
    autodiff at d == 0)."""
    sq = (
        jnp.sum(X * X, axis=1)[:, None]
        - 2.0 * (X @ Y.T)
        + jnp.sum(Y * Y, axis=1)[None, :]
    )
    return jnp.sqrt(jnp.maximum(sq, 0.0))


class RBFKernel:
    """k(x, y) = f(||x - y||) for a SymPy expression f of a distance
    variable and named hyperparameters.

    Parameters
    ----------
    expr: str
        SymPy expression, e.g. ``'exp(-0.5 * d**2 / s**2)'``.
    x: str
        The distance variable's name in ``expr``.
    hyperparameters: name=value pairs for the remaining symbols.
    """

    def __init__(self, expr, x, **hyperparameters):
        self.expr = sympy.sympify(expr)
        self._params = OrderedDict(hyperparameters)
        symbols = [sympy.Symbol(x)] + [
            sympy.Symbol(name) for name in self._params
        ]
        # A single traced scalar map; everything else is jnp + autodiff.
        f = lambdify(symbols, self.expr, modules=[jnp, jax.scipy.special])

        @jax.jit
        def kmat(X, Y, p):
            return f(_pairwise_dist(X, Y), *p)

        @jax.jit
        def kgrad(X, p):
            d = _pairwise_dist(X, X)
            return jax.jacfwd(lambda q: f(d, *q))(p)

        @jax.jit
        def kdiag(n_as_zeros, p):
            return f(n_as_zeros, *p)

        self._kmat, self._kgrad, self._kdiag = kmat, kgrad, kdiag

    @property
    def _p(self):
        return np.asarray(list(self._params.values()), dtype=float)

    def get_params(self):
        return self._params

    @property
    def theta(self):
        return np.log(list(self._params.values()))

    @theta.setter
    def theta(self, args):
        for name, value in zip(self._params, np.exp(args)):
            self._params[name] = value

    def __call__(self, X, Y=None):
        X = np.asarray(X, dtype=float)
        Y = X if Y is None else np.asarray(Y, dtype=float)
        return run(self._kmat, X, Y, self._p)

    def gradient(self, X):
        J = run(self._kgrad, np.asarray(X, dtype=float), self._p)
        return [J[..., i] for i in range(len(self._params))]

    def diag(self, X):
        return run(self._kdiag, np.zeros(len(X)), self._p)
