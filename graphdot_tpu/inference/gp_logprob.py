"""Differentiable GP log-posteriors over kernel hyperparameters.

The reference optimizes a point estimate of theta with L-BFGS
(``gaussian_process/base.py:129-148``); here the same log-marginal
likelihood becomes a traced JAX log-probability that feeds the NUTS / HMC /
SMC / VI samplers in this package — the north-star capability of this
build (BASELINE.json).
"""

import numpy as np
import jax
import jax.numpy as jnp

from .gram import GramFactory


def _mvn_logdensity(K, y, alpha):
    """log N(y | 0, K + alpha I) via Cholesky, in f32-safe form."""
    n = y.shape[0]
    Kr = K + alpha * jnp.eye(n, dtype=K.dtype)
    L = jnp.linalg.cholesky(Kr)
    z = jax.scipy.linalg.solve_triangular(L, y, lower=True)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    return -0.5 * (
        jnp.dot(z, z) + logdet + n * jnp.log(2.0 * jnp.pi)
    )


class GPRLogProb:
    """Log-posterior of a graph-kernel GPR's hyperparameters.

    logp(t) = log N(y | 0, K(t) + alpha I) + log prior(t), where t is the
    log-scale active hyperparameter vector and K is the (normalized) MLGK
    Gram matrix over the training graphs.

    Parameters
    ----------
    kernel: MarginalizedGraphKernel
    X: list of Graph
        Training graphs.
    y: 1-D array
        Training targets (will be zero-meaned unless normalize_y=False).
    alpha: float
        Diagonal regularization / observation noise.
    normalize: bool
        Cosine-normalize the Gram matrix.
    normalize_y: bool
        Standardize targets.
    prior: callable or None
        Extra log-prior over t (defaults to a wide Gaussian in log space
        that keeps the posterior proper).
    prior_scale: float
        Std of the default Gaussian prior on the log hyperparameters.
    maxiter: int
        Per-leapfrog CG iteration cap (see ``GramFactory``): bounds the
        cost of log-density evaluations at extreme-tail hyperparameters,
        where an exact solve is pointless (the sampler rejects them) but
        would otherwise run its full n1*n2-iteration budget.
    """

    def __init__(self, kernel, X, y, alpha=1e-6, normalize=True,
                 normalize_y=True, prior=None, prior_scale=10.0,
                 lmin=0, maxiter=64):
        self.factory = GramFactory(kernel, X, normalize=normalize,
                                   maxiter=maxiter)
        y = np.asarray(y, dtype=np.float64)
        if normalize_y:
            self.ymean, self.ystd = y.mean(), max(y.std(), 1e-300)
        else:
            self.ymean, self.ystd = 0.0, 1.0
        self._y = jnp.asarray(
            (y - self.ymean) / self.ystd, dtype=jnp.float32
        )
        self.alpha = alpha
        self.lmin = lmin
        self.bounds = None
        if prior is None:
            t0 = jnp.asarray(self.factory.theta0, dtype=jnp.float32)

            def prior(t):
                return -0.5 * jnp.sum(((t - t0) / prior_scale) ** 2)
        self.prior = prior

    @property
    def theta0(self):
        return self.factory.theta0

    @property
    def n_dims(self):
        return self.factory.n_active

    def __call__(self, t):
        K = self.factory.gram(t, lmin=self.lmin)
        return (
            _mvn_logdensity(K, self._y, jnp.float32(self.alpha))
            + self.prior(t)
        )

    def value_and_grad(self):
        return jax.value_and_grad(self.__call__)

    def convergence_diagnostics(self, thetas):
        """Worst relative CG residual ||b - A x|| / ||b|| of the Gram
        solves at one or more log-theta points.

        The bounded-effort ``maxiter`` cap (see the class docstring)
        silently truncates solves at extreme hyperparameters. Converged
        float32 solves report ~1e-7..1e-5; values orders of magnitude
        above that at points *inside* the posterior's typical set mean
        the cap is biasing log-densities and should be raised.
        Recommended check after sampling: pass a thinned subset of the
        posterior draws and assert the ratios stay near the converged
        baseline (e.g. < 1e-4).
        """
        if not hasattr(self, '_residual_fn'):
            self._residual_fn = jax.jit(
                lambda t: self.factory.gram(
                    t, lmin=self.lmin, with_residual=True)[1])
        thetas = jnp.atleast_2d(jnp.asarray(thetas, dtype=jnp.float32))
        return np.array([
            float(self._residual_fn(t)) for t in thetas
        ])

    def predict_fn(self, Z):
        """A traced function t -> (mean, var) of the GP posterior at the
        graphs Z given the training set."""
        n = len(self.factory.graphs)
        joint = GramFactory(
            self.factory.kernel, list(self.factory.graphs) + list(Z),
            normalize=self.factory.normalize
        )

        def predict(t):
            Kfull = joint.gram(t, lmin=self.lmin)
            K = Kfull[:n, :n] + self.alpha * jnp.eye(n)
            Ks = Kfull[n:, :n]
            Kss = jnp.diagonal(Kfull[n:, n:])
            L = jnp.linalg.cholesky(K)
            Ky = jax.scipy.linalg.cho_solve((L, True), self._y)
            mean = Ks @ Ky * self.ystd + self.ymean
            V = jax.scipy.linalg.cho_solve((L, True), Ks.T)
            var = jnp.maximum(
                Kss - jnp.sum(Ks * V.T, axis=1), 0.0
            ) * self.ystd ** 2
            return mean, var

        return predict
