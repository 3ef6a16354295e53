"""End-to-end numerical parity: GPR predictions through the JAX solver
must match predictions computed from an independently-built oracle Gram
matrix (dense SciPy CG), fulfilling the BASELINE requirement that model
outputs match the reference within tolerance."""
import numpy as np
import pytest

from graphdot_tpu.kernel import MarginalizedGraphKernel, Normalization
from graphdot_tpu.microkernel import (
    KroneckerDelta, SquareExponential, TensorProduct
)
from graphdot_tpu.model.gaussian_process import GaussianProcessRegressor
from graphdot_tpu.testing import random_molecule_set

from oracle import mlgk


class OracleKernel:
    """Graph kernel evaluated entirely with the dense SciPy oracle —
    the stand-in for the reference implementation."""

    def __init__(self, knode, kedge, q):
        self.knode, self.kedge, self.q = knode, kedge, q

    def _raw(self, X, Y):
        return np.array([
            [mlgk(a, b, self.knode, self.kedge, self.q) for b in Y]
            for a in X
        ])

    def __call__(self, X, Y=None):
        R = self._raw(X, Y if Y is not None else X)
        if Y is None:
            d = np.sqrt(np.diag(R))
            return R / d[:, None] / d[None, :]
        dx = np.sqrt(self._raw(X, X).diagonal())
        dy = np.sqrt(self._raw(Y, Y).diagonal())
        return R / dx[:, None] / dy[None, :]

    def diag(self, X):
        return np.ones(len(X))

    @property
    def theta(self):
        return np.zeros(0)

    @theta.setter
    def theta(self, t):
        pass

    @property
    def bounds(self):
        return np.zeros((0, 2))


@pytest.mark.parametrize('q', [0.05, 0.2])
def test_gpr_predictions_match_oracle(q):
    graphs = random_molecule_set(11, 8, n_atoms_range=(4, 8))
    rng = np.random.default_rng(0)
    y = rng.normal(size=len(graphs))

    knode = TensorProduct(element=KroneckerDelta(0.2))
    kedge = TensorProduct(length=SquareExponential(0.3))

    jax_kernel = Normalization(
        MarginalizedGraphKernel(knode, kedge, q=q)
    )
    oracle_kernel = OracleKernel(knode, kedge, q)

    train, test = list(range(6)), [6, 7]
    Xtr = [graphs[i] for i in train]
    Xte = [graphs[i] for i in test]

    gpr_jax = GaussianProcessRegressor(jax_kernel, alpha=1e-6)
    gpr_jax.fit(Xtr, y[train])
    m_jax, s_jax = gpr_jax.predict(Xte, return_std=True)

    gpr_ref = GaussianProcessRegressor(oracle_kernel, alpha=1e-6)
    gpr_ref.fit(Xtr, y[train])
    m_ref, s_ref = gpr_ref.predict(Xte, return_std=True)

    assert np.allclose(m_jax, m_ref, rtol=1e-4, atol=1e-4)
    assert np.allclose(s_jax, s_ref, rtol=1e-3, atol=1e-4)


def test_gpr_factory_engine_matches_host_path():
    """The GramFactory-backed fit engine (one jitted K+dK program) must
    reproduce the host chunked-solve objective: same LML value and
    gradient, and the same optimized theta through fit()."""
    graphs = random_molecule_set(5, 10, n_atoms_range=(6, 12))
    y = np.array([-1.0 * len(g.nodes) for g in graphs], dtype=float)
    kernel = Normalization(MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.3)),
        TensorProduct(length=SquareExponential(0.3)), q=0.05))
    gpr = GaussianProcessRegressor(kernel=kernel, alpha=1e-3,
                                   normalize_y=True)
    gpr.X = graphs
    gpr.y = y
    gpr._engine = gpr._make_factory_engine(gpr.kernel, gpr._X)
    assert gpr._engine is not None

    t = kernel.theta
    v1, g1 = gpr.log_marginal_likelihood(t, eval_gradient=True)
    gpr._engine = None
    v0, g0 = gpr.log_marginal_likelihood(t, eval_gradient=True)
    assert v1 == pytest.approx(v0, rel=1e-4, abs=1e-4)
    assert np.allclose(g1, g0, rtol=1e-3, atol=1e-3)


def test_gpr_engine_ineligible_inputs():
    """Non-graph data and option-carrying kernels bypass the engine."""
    kernel = Normalization(MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.3)),
        TensorProduct(length=SquareExponential(0.3)), q=0.05))
    gpr = GaussianProcessRegressor(kernel=kernel, alpha=1e-3)
    assert gpr._make_factory_engine(
        kernel, np.random.rand(5, 3)) is None
    gpr_opt = GaussianProcessRegressor(
        kernel=kernel, alpha=1e-3, kernel_options={'nodal': False})
    graphs = random_molecule_set(5, 4, n_atoms_range=(6, 10))
    assert gpr_opt._make_factory_engine(kernel, graphs) is None
