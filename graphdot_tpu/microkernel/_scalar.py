"""Stationary microkernels on scalar features, written out by hand.

Each kernel gives its value once for numpy (host-side ``__call__``) and
jax.numpy (the traced ``apply``), and its analytic jacobian. They equal
the ``MicroKernel.from_sympy`` construction of the same expression
(tested), without sympy on the import path.
"""
from collections import OrderedDict

import numpy as np
import jax.numpy as jnp

from ..util.pretty_tuple import pretty_tuple
from ._base import MicroKernel


class ScalarKernel(MicroKernel):
    """Base of the hand-written scalar kernels. Subclasses set ``name``,
    ``HYPER`` (hyperparameter name -> default bounds) and ``minmax``,
    and implement ``value(xp, x, y, *theta)`` and ``jacobian(x, y,
    *theta)``."""

    HYPER = OrderedDict()

    def __init__(self, *args, **kwargs):
        names = list(self.HYPER)
        if len(args) > len(names):
            raise TypeError(f'{self.name} takes {len(names)} '
                            f'hyperparameters, got {len(args)}')
        self._theta_values = OrderedDict(zip(names, args))
        self._theta_bounds = OrderedDict()
        for n in names:
            if n in kwargs:
                self._theta_values[n] = kwargs[n]
            if n not in self._theta_values:
                raise KeyError(
                    f'Hyperparameter {n} not provided for {self.name}')
            self._theta_bounds[n] = kwargs.get(f'{n}_bounds',
                                               self.HYPER[n])
            self._assert_bounds(n, self._theta_bounds[n])

    def __call__(self, x1, x2, jac=False):
        tv = tuple(self._theta_values.values())
        value = self.value(np, x1, x2, *tv)
        if jac is True:
            return value, np.asarray(self.jacobian(x1, x2, *tv))
        return value

    def apply(self, theta, X, Y):
        return self.value(jnp, X, Y,
                          *[theta[i] for i in range(self.n_theta)])

    def __repr__(self):
        theta = ', '.join(f'{n}={v}' for n, v in self._theta_values.items())
        bounds = ', '.join(f'{n}_bounds={v}'
                           for n, v in self._theta_bounds.items())
        return f'{self.name}({theta}, {bounds})'

    @property
    def n_theta(self):
        return len(self.HYPER)

    @property
    def state(self):
        return tuple(self._theta_values.values())

    @property
    def theta(self):
        return pretty_tuple(self.name, self._theta_values.keys())(
            **self._theta_values)

    @theta.setter
    def theta(self, seq):
        assert len(seq) == len(self._theta_values)
        for n, v in zip(self.HYPER, seq):
            self._theta_values[n] = v

    @property
    def bounds(self):
        return tuple(self._theta_bounds.values())


class SquareExponential(ScalarKernel):
    r"""Gaussian similarity on scalar features: decays smoothly from 1
    toward 0 with the squared distance between the inputs,
    :math:`k(x, y) = \exp(-\frac{(x - y)^2}{2\sigma^2})`.

    Parameters
    ----------
    length_scale: float32
        Distance scale of the decay: the kernel falls to ~0.61 at one
        length scale and is negligible (~0.01) beyond three.
    length_scale_bounds: tuple or "fixed"
        Optimization bounds of `length_scale`, or "fixed".
    """

    name = 'SquareExponential'
    HYPER = OrderedDict(length_scale=(1e-6, np.inf))
    minmax = (0, 1)

    @staticmethod
    def value(xp, x, y, length_scale):
        return xp.exp(-0.5 * (x - y) ** 2 * length_scale ** -2)

    @staticmethod
    def jacobian(x, y, length_scale):
        d2 = (x - y) ** 2
        return [np.exp(-0.5 * d2 / length_scale ** 2) * d2
                / length_scale ** 3]


class RationalQuadratic(ScalarKernel):
    r"""A scale mixture of square-exponential kernels:
    :math:`k(x, y) = (1 + \frac{(x-y)^2}{2\alpha\ell^2})^{-\alpha}`.
    Small alpha mixes in long length scales; as alpha grows the kernel
    approaches a single square exponential of scale ell.

    Parameters
    ----------
    length_scale: float32
        The smallest constituent length scale.
    alpha: float32
        Mixture concentration: larger values suppress the long-length-
        scale components faster.
    length_scale_bounds, alpha_bounds: tuple or "fixed"
        Optimization bounds, or "fixed".
    """

    name = 'RationalQuadratic'
    HYPER = OrderedDict(length_scale=(1e-6, np.inf), alpha=(1e-3, np.inf))
    minmax = (0, 1)

    @staticmethod
    def value(xp, x, y, length_scale, alpha):
        return (1 + (x - y) ** 2 / (2 * alpha * length_scale ** 2)) \
            ** (-alpha)

    @staticmethod
    def jacobian(x, y, length_scale, alpha):
        d2 = (x - y) ** 2
        u = 1 + d2 / (2 * alpha * length_scale ** 2)
        k = u ** (-alpha)
        return [u ** (-alpha - 1) * d2 / length_scale ** 3,
                k * (d2 / (2 * alpha * length_scale ** 2 * u)
                     - np.log(u))]
