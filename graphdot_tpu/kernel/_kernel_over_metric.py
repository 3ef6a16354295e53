"""Kernel defined as a function of a distance metric (fills the role of
the reference's ``graphdot/kernel/_kernel_over_metric.py:11``), in JAX:
the scalar map f runs on device and all of its derivatives — with respect
to both its own hyperparameters and the distance input (for chaining
through the metric's gradient) — come from one ``jax.jacfwd`` pass
instead of per-parameter symbolic differentiation."""
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import sympy
from sympy.utilities.lambdify import lambdify

from ..linalg._exec import run
from ..util.pretty_tuple import pretty_tuple


def _parse_hyper_spec(val):
    """value | (value,) | (value, bounds) | (value, lb, ub)."""
    if not hasattr(val, '__iter__'):
        return val, (0, np.inf)
    val = tuple(val)
    if len(val) == 1:
        return val[0], (0, np.inf)
    if len(val) == 2:
        return val[0], val[1]
    if len(val) == 3:
        return val[0], (val[1], val[2])
    raise ValueError(f'Bad hyperparameter spec {val!r}')


class KernelOverMetric:
    """k(x, y) = f(d(x, y)) with gradients chained through both f's
    hyperparameters and the distance metric's.

    Parameters
    ----------
    distance: metric object with theta / bounds / clone_with_theta.
    expr: str
        SymPy expression in the distance variable plus hyperparameters.
    x: str
        Distance variable name.
    hyperparameters: name=value or name=(value, bounds...) pairs.
    """

    def __init__(self, distance, expr, x, **hyperparameters):
        self._init_args = (expr, x)
        self._init_kwargs = hyperparameters
        self.distance = distance
        self.expr = sympy.sympify(expr)
        self.x = x
        self._hyperparams = OrderedDict()
        self._hyperbounds = OrderedDict()
        for name, spec in hyperparameters.items():
            value, bounds = _parse_hyper_spec(spec)
            self._hyperparams[name] = value
            self._hyperbounds[name] = bounds

        symbols = [sympy.Symbol(x)] + [
            sympy.Symbol(name) for name in self._hyperparams
        ]
        f = lambdify(symbols, self.expr, modules=[jnp, jax.scipy.special])

        @jax.jit
        def kfun(D, p):
            return f(D, *p)

        @jax.jit
        def kjac(D, p):
            # forward mode over the (few) hyperparameters; a single JVP
            # for the elementwise distance derivative
            dp = jax.jacfwd(lambda q: f(D, *q))(p)
            _, dd = jax.jvp(
                lambda d: f(d, *p), (D,), (jnp.ones_like(D),)
            )
            return dp, dd

        self._kfun, self._kjac = kfun, kjac

    def _values(self):
        return np.asarray(list(self._hyperparams.values()), dtype=float)

    def __call__(self, X, Y=None, eval_gradient=False):
        if not eval_gradient:
            return run(self._kfun, self.distance(X, Y), self._values())
        D, dD = self.distance(X, Y, eval_gradient=True)
        K = run(self._kfun, D, self._values())
        dp, dd = run(self._kjac, D, self._values())
        n_own = len(self._hyperparams)
        n_dist = len(self.distance.theta)
        grad = np.empty((*D.shape, n_own + n_dist), order='F')
        grad[:, :, :n_own] = dp
        if n_dist:
            grad[:, :, n_own:] = dd[:, :, None] * dD
        return K, grad

    def diag(self, X):
        return run(self._kfun, np.zeros(len(X)), self._values())

    def get_params(self):
        return self._hyperparams

    @property
    def theta(self):
        return np.concatenate((
            np.log(list(self._hyperparams.values())),
            self.distance.theta,
        ))

    @theta.setter
    def theta(self, args):
        own = len(self._hyperparams)
        for name, value in zip(self._hyperparams, np.exp(args[:own])):
            self._hyperparams[name] = value
        self.distance.theta = args[own:]

    @property
    def bounds(self):
        return np.vstack((
            np.log(np.vstack(list(self._hyperbounds.values()))),
            self.distance.bounds,
        ))

    @property
    def hyperparameters(self):
        return pretty_tuple(
            'RBFKernel',
            list(self._hyperparams) + ['distance']
        )(*self._hyperparams.values(), self.distance.hyperparameters)

    def clone_with_theta(self, theta=None):
        if theta is None:
            theta = self.theta
        twin = type(self)(
            self.distance.clone_with_theta(self.distance.theta),
            *self._init_args, **self._init_kwargs
        )
        twin.theta = theta
        return twin
