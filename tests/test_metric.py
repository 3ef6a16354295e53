"""Metric tests: MaxiMin vs brute force, kernel-induced distance
(reference strategy: ``test/metric/maximin/test_maximin.py``)."""
import networkx as nx
import numpy as np
import pytest

from graphdot_tpu import Graph
from graphdot_tpu.kernel import MarginalizedGraphKernel
from graphdot_tpu.metric import KernelInducedDistance, MaxiMin
from graphdot_tpu.microkernel import (
    KroneckerDelta, SquareExponential, TensorProduct
)


def _graphs():
    gs = []
    for seed, n in [(0, 5), (1, 6), (2, 4)]:
        rng = np.random.default_rng(seed)
        g = nx.newman_watts_strogatz_graph(n, 3, 0.3, seed=seed)
        nx.set_node_attributes(
            g, {k: int(rng.integers(1, 4)) for k in g.nodes}, 'element'
        )
        nx.set_edge_attributes(
            g, {e: float(rng.uniform(0.9, 1.4)) for e in g.edges},
            'length'
        )
        gs.append(Graph.from_networkx(g))
    return Graph.unify_datatype(gs)


def _kernel(**kw):
    return dict(
        node_kernel=TensorProduct(element=KroneckerDelta(0.3)),
        edge_kernel=TensorProduct(length=SquareExponential(0.3)),
        q=0.1, **kw
    )


def brute_force_maximin(mlgk, G):
    """Independent reduction from nodal similarity matrices."""
    n = len(G)
    sizes = [len(g.nodes) for g in G]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    R = mlgk(G, nodal=True)
    diag = np.diagonal(R)
    D = np.zeros((n, n))
    for a in range(n):
        for b in range(n):
            k12 = R[starts[a]:starts[a + 1], starts[b]:starts[b + 1]]
            k1 = diag[starts[a]:starts[a + 1]]
            k2 = diag[starts[b]:starts[b + 1]]
            d = np.sqrt(np.maximum(
                0, 1 - k12 / np.sqrt(np.outer(k1, k2))
            ))
            D[a, b] = max(d.min(axis=1).max(), d.min(axis=0).max())
    return D


def test_maximin_matches_brute_force():
    G = _graphs()
    kw = _kernel()
    metric = MaxiMin(kw['node_kernel'], kw['edge_kernel'], q=kw['q'])
    mlgk = MarginalizedGraphKernel(
        kw['node_kernel'], kw['edge_kernel'], q=kw['q']
    )
    D = metric(G)
    D_ref = brute_force_maximin(mlgk, G)
    assert np.allclose(D, D_ref, atol=1e-5)
    assert np.allclose(np.diag(D), 0, atol=1e-3)
    assert np.allclose(D, D.T, atol=1e-7)


def test_maximin_device_fn_matches_host():
    """The fully on-device pipeline (one jitted program: nodal solves
    + masked maximin reduction) agrees with the host-orchestrated
    path; it is what ``bench_maximin.py`` scan-slope times."""
    G = _graphs()
    kw = _kernel()
    metric = MaxiMin(kw['node_kernel'], kw['edge_kernel'], q=kw['q'])
    D = metric(G)
    fn, theta0 = metric.device_distance_fn(G)
    D_dev = np.asarray(fn(theta0))
    assert np.allclose(D_dev, D, atol=5e-4)
    assert np.allclose(D_dev, D_dev.T, atol=1e-7)


def test_maximin_cross():
    G = _graphs()
    kw = _kernel()
    metric = MaxiMin(kw['node_kernel'], kw['edge_kernel'], q=kw['q'])
    D = metric(G)
    D2 = metric(G[:2], G[2:])
    assert np.allclose(D2.ravel(), D[:2, 2:].ravel(), atol=1e-6)


def test_maximin_hotspot():
    G = _graphs()
    kw = _kernel()
    metric = MaxiMin(kw['node_kernel'], kw['edge_kernel'], q=kw['q'])
    D, (h1, h2) = metric(G, return_hotspot=True)
    sizes = np.array([len(g.nodes) for g in G])
    assert np.all(h1 < sizes[:, None])
    assert np.all(h2 < sizes[None, :])


def test_maximin_gradient_fd():
    G = _graphs()
    kw = _kernel()
    metric = MaxiMin(kw['node_kernel'], kw['edge_kernel'], q=kw['q'])
    D, dD = metric(G, eval_gradient=True)
    assert dD.shape == (len(G), len(G), len(metric.theta))
    eps = 1e-3
    theta0 = metric.theta.copy()
    for i in range(len(theta0)):
        tp = theta0.copy()
        tp[i] += eps
        metric.theta = tp
        Dp = metric(G)
        tm = theta0.copy()
        tm[i] -= eps
        metric.theta = tm
        Dm = metric(G)
        metric.theta = theta0
        fd = (Dp - Dm) / (2 * eps) / np.exp(theta0[i])
        # gradients only defined away from the sqrt kink; compare
        # off-diagonal entries with a loose tolerance like the reference
        off = ~np.eye(len(G), dtype=bool)
        assert np.allclose(
            dD[:, :, i][off], fd[off], rtol=0.1, atol=0.05
        ), f'theta[{i}]'


def test_kernel_induced_distance():
    G = _graphs()
    kw = _kernel()
    mlgk = MarginalizedGraphKernel(
        kw['node_kernel'], kw['edge_kernel'], q=kw['q']
    )
    from graphdot_tpu.kernel.fix import Normalization
    kid = KernelInducedDistance(Normalization(mlgk))
    D = kid(G)
    assert np.allclose(np.diag(D), 0, atol=1e-3)
    assert np.all(D >= 0)
    D2, dD = kid(G, eval_gradient=True)
    assert np.allclose(D, D2)
    assert dD.shape[2] == len(mlgk.theta)


def test_m3_metric_and_oracle_crosscheck():
    """The experimental M3 metric: zero self-distance, symmetry, and —
    the real point — its independent sparse-SciPy MLGK solve agrees with
    the package's batched solver on the same kernels."""
    from graphdot_tpu.dataset._atoms import make_atoms
    from graphdot_tpu.experimental.metric import M3
    from graphdot_tpu.graph import Graph

    rng = np.random.default_rng(0)
    atoms1 = make_atoms([6, 6, 8, 1], rng.normal(size=(4, 3)) * 1.2)
    atoms2 = make_atoms([6, 7, 8], rng.normal(size=(3, 3)) * 1.2)

    m3 = M3(q=0.05)
    assert m3(atoms1, atoms1) == pytest.approx(0.0, abs=1e-4)
    d12 = m3(atoms1, atoms2)
    assert d12 > 0.01
    assert m3(atoms2, atoms1) == pytest.approx(d12, rel=1e-5)

    # crosscheck: M3's scipy CG vs the package solver, nodal mode
    args = dict(use_charge=False, adjacency=m3.adjacency)
    g1 = Graph.from_ase(atoms1, **args)
    g2 = Graph.from_ase(atoms2, **args)
    R_scipy = m3._mlgk(g1, g2)
    mlgk = MarginalizedGraphKernel(
        m3.node_kernel, m3.edge_kernel, q=m3.q, backend='edge'
    )
    R_jax = mlgk([g1], [g2], nodal=True)
    assert np.allclose(R_scipy, R_jax, rtol=1e-4, atol=1e-5)
