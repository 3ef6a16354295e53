"""MLGK solver correctness vs the dense CPU oracle.

Replicates the reference test strategy
(``test/kernel/marginalized/test_kernel.py``): case matrix of
unlabeled / labeled / weighted / variable-length-feature graphs crossed
with q in {0.01, 0.05, 0.1, 0.5}, checked for self-similarity, cross
consistency, diagonal modes, permutation invariance, and
finite-difference gradient agreement.
"""
import numpy as np
import networkx as nx
import pytest

from graphdot_tpu import Graph
from graphdot_tpu.kernel import MarginalizedGraphKernel
from graphdot_tpu.microkernel import (
    Additive,
    Constant,
    Convolution,
    KroneckerDelta,
    SquareExponential,
    TensorProduct,
)

from oracle import mlgk, mlgk_pair


def _nx(title, nodes, edges):
    g = nx.Graph(title=title)
    for n, attrs in nodes:
        g.add_node(n, **attrs)
    for u, v, attrs in edges:
        g.add_edge(u, v, **attrs)
    return g


_g_unlabeled = [
    _nx('U1', [(i, {}) for i in range(3)],
        [(0, 1, {}), (0, 2, {})]),
    _nx('U2', [(i, {}) for i in range(3)],
        [(0, 1, {}), (0, 2, {}), (1, 2, {})]),
]

_g_labeled = [
    _nx('L1',
        [('O1', dict(category=2, charge=1.0)),
         ('H1', dict(category=3, charge=-1.0)),
         ('H2', dict(category=1, charge=2.0))],
        [('O1', 'H1', dict(order=1, length=0.5)),
         ('O1', 'H2', dict(order=2, length=1.0))]),
    _nx('L2',
        [('H1', dict(category=1, charge=1.0)),
         ('H2', dict(category=1, charge=-1.0))],
        [('H1', 'H2', dict(order=2, length=1.0))]),
]

_g_weighted = [
    _nx('W1',
        [('O1', dict(category=2)), ('H1', dict(category=3)),
         ('H2', dict(category=1))],
        [('O1', 'H1', dict(w=1.0, length=0.5)),
         ('O1', 'H2', dict(w=2.0, length=1.0))]),
    _nx('W2',
        [('H1', dict(category=1)), ('H2', dict(category=1))],
        [('H1', 'H2', dict(w=3.0, length=1.0))]),
]

_g_vario = [
    _nx('V1',
        [('O1', dict(rings=(5, 6))), ('H1', dict(rings=(3,))),
         ('H2', dict(rings=(2, 3, 4)))],
        [('O1', 'H1', dict(w=1.0, spectrum=(3, 4))),
         ('O1', 'H2', dict(w=2.0, spectrum=(3, 5)))]),
    _nx('V2',
        [('H1', dict(rings=(3, 4))), ('H2', dict(rings=(3,)))],
        [('H1', 'H2', dict(w=3.0, spectrum=(2, 4)))]),
]


def make_cases():
    return {
        'unlabeled': dict(
            graphs=Graph.unify_datatype([
                Graph.from_networkx(g) for g in _g_unlabeled
            ]),
            knode=Constant(1.0),
            kedge=Constant(1.0),
        ),
        'labeled': dict(
            graphs=Graph.unify_datatype([
                Graph.from_networkx(g) for g in _g_labeled
            ]),
            knode=TensorProduct(
                category=KroneckerDelta(0.3),
                charge=SquareExponential(1.0) + 0.01
            ).normalized,
            kedge=Additive(
                order=KroneckerDelta(0.3),
                length=SquareExponential(0.05)
            ).normalized,
        ),
        'weighted': dict(
            graphs=Graph.unify_datatype([
                Graph.from_networkx(g, weight='w') for g in _g_weighted
            ]),
            knode=TensorProduct(category=KroneckerDelta(0.3)),
            kedge=TensorProduct(length=SquareExponential(0.05)),
        ),
        'vario': dict(
            graphs=Graph.unify_datatype([
                Graph.from_networkx(g, weight='w') for g in _g_vario
            ]),
            knode=TensorProduct(rings=Convolution(KroneckerDelta(0.3))),
            kedge=TensorProduct(
                spectrum=Convolution(SquareExponential(1.0))
            ),
        ),
    }


CASES = make_cases()
QS = [0.01, 0.05, 0.1, 0.5]
BACKENDS = ['dense', 'edge']


@pytest.mark.parametrize('backend', BACKENDS)
@pytest.mark.parametrize('case', CASES.keys())
def test_self_similarity(case, backend):
    c = CASES[case]
    G = c['graphs']
    for q in QS:
        k = MarginalizedGraphKernel(
            c['knode'], c['kedge'], q=q, backend=backend
        )
        R = k(G)
        assert R.shape == (len(G), len(G))
        assert np.allclose(R, R.T)
        for idx in range(len(G)):
            gnd = mlgk(G[idx], G[idx], c['knode'], c['kedge'], q)
            assert R[idx, idx] == pytest.approx(gnd, rel=1e-4)
        d = np.diag(R) ** -0.5
        K = np.diag(d) @ R @ np.diag(d)
        assert np.allclose(np.diag(K), 1, atol=1e-6)


@pytest.mark.parametrize('backend', BACKENDS)
@pytest.mark.parametrize('case', CASES.keys())
def test_cross_similarity(case, backend):
    c = CASES[case]
    G = c['graphs']
    for q in [0.05, 0.5]:
        k = MarginalizedGraphKernel(
            c['knode'], c['kedge'], q=q, backend=backend
        )
        R = k(G)
        gnd = mlgk(G[0], G[1], c['knode'], c['kedge'], q)
        assert R[0, 1] == pytest.approx(gnd, rel=1e-4)
        # sub-matrix consistency
        assert np.allclose(k(G[:1], G).ravel(), R[:1, :].ravel(),
                           rtol=1e-5, atol=1e-7)
        assert np.allclose(k(G, G[1:]).ravel(), R[:, 1:].ravel(),
                           rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('backend', BACKENDS)
@pytest.mark.parametrize('case', CASES.keys())
def test_diag_modes(case, backend):
    c = CASES[case]
    G = c['graphs']
    q = 0.1
    k = MarginalizedGraphKernel(c['knode'], c['kedge'], q=q,
                                backend=backend)
    R = k(G)
    D = k.diag(G)
    assert len(D) == len(G)
    assert np.allclose(D, np.diag(R), rtol=1e-6)

    R_nodal = k(G, nodal=True)
    sizes = [len(g.nodes) for g in G]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    assert R_nodal.shape == (starts[-1], starts[-1])
    assert np.allclose(R_nodal, R_nodal.T, atol=1e-8)
    for idx, g in enumerate(G):
        gnd = mlgk_pair(g, g, c['knode'], c['kedge'], q)
        sub = R_nodal[starts[idx]:starts[idx + 1],
                      starts[idx]:starts[idx + 1]]
        assert np.allclose(sub, gnd, rtol=1e-4, atol=1e-6)

    D_nodal = k.diag(G, nodal=True)
    assert len(D_nodal) == starts[-1]
    assert np.allclose(D_nodal, np.diag(R_nodal), rtol=1e-6, atol=1e-8)

    blocks = k.diag(G, nodal='block')
    assert len(blocks) == len(G)
    for idx in range(len(G)):
        sub = R_nodal[starts[idx]:starts[idx + 1],
                      starts[idx]:starts[idx + 1]]
        assert np.allclose(blocks[idx], sub, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('backend', BACKENDS)
@pytest.mark.parametrize('nodal', [False, True])
@pytest.mark.parametrize('case', CASES.keys())
def test_gradient(case, nodal, backend):
    c = CASES[case]
    G = c['graphs']
    for q in [0.05, 0.5]:
        k = MarginalizedGraphKernel(c['knode'], c['kedge'], q=q,
                                    backend=backend)
        R, dR = k(G, nodal=nodal, eval_gradient=True)
        assert dR.ndim == 3
        assert dR.shape[:2] == R.shape
        assert dR.shape[2] == len(k.theta)

        eps = 1e-3
        for t in range(len(k.theta)):
            theta0 = k.theta
            tp = np.copy(theta0)
            tp[t] += eps
            k.theta = tp
            Rp = k(G, nodal=nodal)
            tm = np.copy(theta0)
            tm[t] -= eps
            k.theta = tm
            Rm = k(G, nodal=nodal)
            k.theta = theta0
            dR_dt = (Rp - Rm) / (2 * eps) / np.exp(theta0[t])
            assert np.allclose(dR[:, :, t], dR_dt, rtol=0.05, atol=0.05), \
                f'{case} q={q} theta[{t}]'


@pytest.mark.parametrize('backend', BACKENDS)
def test_lmin(backend):
    c = CASES['labeled']
    G = c['graphs']
    q = 0.1
    k = MarginalizedGraphKernel(c['knode'], c['kedge'], q=q,
                                backend=backend)
    R = k(G, lmin=1)
    gnd = mlgk(G[0], G[1], c['knode'], c['kedge'], q, lmin=1)
    assert R[0, 1] == pytest.approx(gnd, rel=1e-4, abs=1e-6)


@pytest.mark.parametrize('backend', BACKENDS)
def test_permutation_invariance(backend):
    c = CASES['labeled']
    G = c['graphs']
    q = 0.1
    k = MarginalizedGraphKernel(c['knode'], c['kedge'], q=q,
                                backend=backend)
    R = k(G)
    perm = [2, 0, 1]
    G2 = [G[0].permute(perm), G[1]]
    R2 = k(G2)
    assert np.allclose(R, R2, rtol=1e-5)


def test_typecheck():
    knode = Constant(1.0)
    kedge = Constant(1.0)
    k = MarginalizedGraphKernel(knode, kedge, q=0.5)
    g_u = Graph.from_networkx(_g_unlabeled[0])
    g_l = Graph.from_networkx(_g_labeled[0])
    with pytest.raises(TypeError):
        k([g_u, g_l])


def test_self_loops():
    g = nx.Graph(title='SL')
    g.add_nodes_from([0, 1])
    g.add_edge(0, 0)
    g.add_edge(0, 1)
    G = [Graph.from_networkx(g)]
    for backend in BACKENDS:
        k = MarginalizedGraphKernel(Constant(1.0), Constant(1.0), q=0.2,
                                    backend=backend)
        R = k(G)
        gnd = mlgk(G[0], G[0], Constant(1.0), Constant(1.0), 0.2)
        assert R[0, 0] == pytest.approx(gnd, rel=1e-4)


def test_fixed_hyperparameters_excluded():
    knode = TensorProduct(category=KroneckerDelta(0.3, h_bounds='fixed'))
    kedge = TensorProduct(length=SquareExponential(0.05))
    k = MarginalizedGraphKernel(knode, kedge, q=0.1)
    # active: p, q, length_scale (category h is fixed)
    assert len(k.theta) == 3
    R, dR = k(CASES['weighted']['graphs'], eval_gradient=True)
    assert dR.shape[2] == 3


def test_starting_probability():
    from graphdot_tpu.kernel.marginalized import Uniform
    c = CASES['unlabeled']
    G = c['graphs']
    q = 0.2
    k1 = MarginalizedGraphKernel(c['knode'], c['kedge'], p=1.0, q=q)
    k2 = MarginalizedGraphKernel(c['knode'], c['kedge'], p=Uniform(2.0),
                                 q=q)
    assert np.allclose(4 * k1(G), k2(G), rtol=1e-6)
    # adhoc starting probability
    k3 = MarginalizedGraphKernel(
        c['knode'], c['kedge'],
        p=(lambda nodes: 2.0 * np.ones(len(nodes)), '2.0f'), q=q
    )
    assert np.allclose(k2(G), k3(G), rtol=1e-6)


def test_large_random_batch():
    rng = np.random.default_rng(0)
    graphs = []
    for i in range(10):
        n = int(rng.integers(4, 12))
        g = nx.newman_watts_strogatz_graph(n, 3, 0.2, seed=int(i))
        nx.set_node_attributes(
            g, {k: float(rng.normal()) for k in g.nodes}, 'x'
        )
        nx.set_edge_attributes(
            g, {e: float(rng.uniform(0.5, 1.5)) for e in g.edges}, 'length'
        )
        graphs.append(Graph.from_networkx(g))
    graphs = Graph.unify_datatype(graphs)
    knode = TensorProduct(x=SquareExponential(1.0) + 0.01)
    kedge = TensorProduct(length=SquareExponential(0.5) + 0.01)
    k = MarginalizedGraphKernel(knode, kedge, q=0.1)
    R = k(graphs)
    assert R.shape == (10, 10)
    assert np.allclose(R, R.T)
    assert np.all(np.diag(R) > 0)
    # spot check two pairs against the oracle
    for (a, b) in [(0, 0), (2, 7)]:
        gnd = mlgk(graphs[a], graphs[b], knode, kedge, 0.1)
        assert R[a, b] == pytest.approx(gnd, rel=1e-3)


@pytest.mark.parametrize('backend', BACKENDS)
def test_bucketed_solving(backend):
    """Bucketed per-size-class batches must agree with the global-padding
    path, including cross-bucket (rectangular) pairs."""
    rng = np.random.default_rng(5)
    graphs = []
    for i, n in enumerate([4, 5, 12, 13, 21, 6]):
        g = nx.newman_watts_strogatz_graph(n, 3, 0.2, seed=int(i))
        nx.set_node_attributes(
            g, {k: float(rng.normal()) for k in g.nodes}, 'x'
        )
        nx.set_edge_attributes(
            g, {e: float(rng.uniform(0.8, 1.2)) for e in g.edges},
            'length'
        )
        graphs.append(Graph.from_networkx(g))
    graphs = Graph.unify_datatype(graphs)
    knode = TensorProduct(x=SquareExponential(1.0) + 0.01)
    kedge = TensorProduct(length=SquareExponential(0.5) + 0.01)

    k_flat = MarginalizedGraphKernel(knode, kedge, q=0.1, backend=backend)
    k_buck = MarginalizedGraphKernel(
        knode, kedge, q=0.1, backend=backend, buckets=True
    )
    R1 = k_flat(graphs)
    R2 = k_buck(graphs)
    assert np.allclose(R1, R2, rtol=1e-4, atol=1e-6)

    Rn1 = k_flat(graphs, nodal=True)
    Rn2 = k_buck(graphs, nodal=True)
    assert np.allclose(Rn1, Rn2, rtol=1e-4, atol=1e-6)

    _, dR1 = k_flat(graphs, eval_gradient=True)
    _, dR2 = k_buck(graphs, eval_gradient=True)
    assert np.allclose(dR1, dR2, rtol=1e-3, atol=1e-4)

    D1 = k_flat.diag(graphs, nodal=True)
    D2 = k_buck.diag(graphs, nodal=True)
    assert np.allclose(D1, D2, rtol=1e-5)


def test_element_dtype():
    c = CASES['unlabeled']
    G = c['graphs']
    k32 = MarginalizedGraphKernel(
        c['knode'], c['kedge'], q=0.2, dtype=np.float32
    )
    R32 = k32(G)
    assert R32.dtype == np.float32
    k64 = MarginalizedGraphKernel(
        c['knode'], c['kedge'], q=0.2, dtype=np.float64
    )
    assert k64(G).dtype == np.float64
    assert k64.diag(G).dtype == np.float64


def test_diag_gradient_full_dims():
    """active_theta_only=False returns gradients for ALL hyperparameters
    (the MaxiMin code path)."""
    c = CASES['weighted']
    G = c['graphs']
    k = MarginalizedGraphKernel(c['knode'], c['kedge'], q=0.1)
    d, dd = k.diag(G, eval_gradient=True, nodal=True,
                   active_theta_only=False)
    assert dd.shape == (len(d), k.n_dims)
    d2, dd2 = k.diag(G, eval_gradient=True, nodal=True)
    assert dd2.shape == (len(d), len(k.theta))


def test_alt_mgk_explicit_pairs():
    """AltMarginalizedGraphKernel evaluates K only at requested pairs and
    agrees with the full Gram matrix."""
    from graphdot_tpu.experimental.alternative_mgk import (
        AltMarginalizedGraphKernel
    )
    c = CASES['weighted']
    G = c['graphs']
    full = MarginalizedGraphKernel(c['knode'], c['kedge'], q=0.1)
    alt = AltMarginalizedGraphKernel(c['knode'], c['kedge'], q=0.1)
    R = full(G)
    ij = [(0, 1), (1, 1), (0, 0), (1, 0)]
    v = alt(G, ij)
    assert v.shape == (4,)
    want = [R[i, j] for i, j in ij]
    assert np.allclose(v, want, rtol=1e-5)


def test_pallas_backend_matches_edge(interpreted_pallas):
    """The fused PCG kernel (Pallas interpreter, Triton route) agrees
    with the XLA edge backend, including rectangular (n1 != n2) pair
    batches and gradients through ``custom_linear_solve``."""
    c = CASES['weighted']
    G = c['graphs']
    ke = MarginalizedGraphKernel(c['knode'], c['kedge'], q=0.1,
                                 backend='edge')
    kp = MarginalizedGraphKernel(c['knode'], c['kedge'], q=0.1,
                                 backend='pallas')
    Re, dRe = ke(G, eval_gradient=True)
    Rp, dRp = kp(G, eval_gradient=True)
    assert np.allclose(Re, Rp, rtol=1e-5, atol=1e-7)
    assert np.allclose(dRe, dRp, rtol=1e-3, atol=1e-5)

    # rectangular pairs via heterogeneous bucket classes (sized for
    # the fast tier: every extra size class compiles its own
    # interpret-mode program)
    from graphdot_tpu.inference import GramFactory
    from graphdot_tpu.testing import random_molecule_set
    import jax
    import jax.numpy as jnp
    mols = random_molecule_set(11, 6, n_atoms_range=(5, 14))
    knode = TensorProduct(element=KroneckerDelta(0.2))
    kedge = TensorProduct(length=SquareExponential(0.3))
    fe = GramFactory(MarginalizedGraphKernel(knode, kedge, q=0.05,
                                             backend='edge'), mols)
    fp = GramFactory(MarginalizedGraphKernel(knode, kedge, q=0.05,
                                             backend='pallas'), mols)
    assert fp._groups is not None and len(fp._groups) > 1
    t0 = jnp.asarray(fe.theta0, dtype=jnp.float32)
    Ke = np.asarray(fe.gram(t0))
    Kp = np.asarray(fp.gram(t0))
    assert np.allclose(Ke, Kp, rtol=1e-5, atol=1e-6)
    ge = np.asarray(jax.grad(lambda t: jnp.sum(fe.gram(t) ** 2))(t0))
    gp = np.asarray(jax.grad(lambda t: jnp.sum(fp.gram(t) ** 2))(t0))
    assert np.allclose(ge, gp, rtol=1e-3, atol=1e-4)


def _random_system(rng, P, M1, M2, N1, N2, dominance=1.0):
    """Random SPD product-graph systems in the fused kernel's operand
    layout, plus the matvec of each as a dense numpy matrix.
    ``dominance`` scales the diagonal, for dense graphs (many edges per
    node) whose couplings would otherwise outweigh it."""
    T = rng.uniform(0.1, 0.5, (P, M1, M2)).astype(np.float32)
    idx = [rng.integers(0, n, (P, m)).astype(np.int32)
           for n, m in ((N1, M1), (N1, M1), (N2, M2), (N2, M2))]
    # strongly diagonally dominant -> SPD regardless of the couplings
    diag = (dominance * rng.uniform(20.0, 30.0, (P, N1, N2))).astype(
        np.float32)
    b = rng.normal(size=(P, N1, N2)).astype(np.float32)
    dense = []
    for p in range(P):
        S1, D1 = np.eye(N1)[idx[0][p]], np.eye(N1)[idx[1][p]]
        S2, D2 = np.eye(N2)[idx[2][p]], np.eye(N2)[idx[3][p]]

        def mv(y):
            Y = y.reshape(N1, N2)
            return (diag[p] * Y
                    - S1.T @ (T[p] * (D1 @ Y @ D2.T)) @ S2).ravel()
        dense.append(np.stack([mv(e) for e in np.eye(N1 * N2)], 1))
    return T, idx, diag, b, dense


def _check_fused_pcg(dims, dominance=1.0):
    from graphdot_tpu.ops.pallas_pcg import fused_pcg
    P, M1, M2, N1, N2 = dims
    T, idx, diag, b, dense = _random_system(
        np.random.default_rng(P + M1), P, M1, M2, N1, N2, dominance)
    x = np.asarray(fused_pcg(
        T, *idx, diag, 1.0 / diag, b, np.full(P, 1e-6, np.float32),
        maxiter=256))
    assert x.shape == (P, N1, N2)
    for p in range(P):
        want = np.linalg.solve(dense[p], b[p].ravel())
        assert np.allclose(x[p].ravel(), want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('dims', [
    (3, 20, 13, 9, 7),      # rectangular, every dim padded
    (2, 16, 16, 16, 16),    # already at the kernel's tile sizes
    (1, 40, 33, 17, 5),     # M and N across power-of-two boundaries
    (2, 52, 52, 24, 24),    # a 24-atom molecule pair, padded to 64/32
    (1, 6, 70, 3, 20),      # one tiny side against a larger one
    (1, 1, 16, 1, 16),      # a single edge and node on one side
])
def test_fused_pcg_matches_dense_solve(interpreted_pallas, dims):
    """The fused kernel (interpreted) solves each pair's system to the
    dense numpy solution, through the padding of every dimension to a
    power of two >= 16."""
    _check_fused_pcg(dims)


@pytest.mark.gpu
@pytest.mark.parametrize('dims', [
    (2, 128, 128, 16, 16),
    (2, 128, 64, 32, 32),
    (2, 128, 128, 32, 16),
    (2, 32, 32, 64, 64),
    (2, 256, 64, 16, 16),
    (2, 64, 64, 32, 64),
])
def test_fused_pcg_at_the_size_limit_on_gpu(gpu, dims):
    """The largest operand shapes the size rule admits compile for the
    card and solve to the dense solution; one step beyond each, the rule
    sends the pair to the XLA solver."""
    from graphdot_tpu.ops.pallas_pcg import fits
    _, M1, M2, N1, N2 = dims
    assert fits(M1, M2, N1, N2)
    assert not fits(2 * M1, M2, N1, N2) or not fits(M1, M2, 2 * N1, N2)
    _check_fused_pcg(dims, dominance=M1 * M2 / (N1 * N2))


def test_fused_pcg_vmap_and_custom_linear_solve(interpreted_pallas):
    """Under ``custom_linear_solve`` the fused kernel serves the primal,
    tangent and transpose solves: its jvp and vjp agree with the XLA PCG
    on the same system, and vmapping over right-hand sides (jacfwd's
    batching) gives the stacked solves."""
    import jax
    import jax.numpy as jnp
    from graphdot_tpu.kernel.marginalized._solver import pcg, solve_linear
    from graphdot_tpu.ops.pallas_pcg import fused_pcg_solver
    P, M1, M2, N1, N2 = 2, 12, 10, 6, 5
    T, idx, diag, b, _ = _random_system(
        np.random.default_rng(7), P, M1, M2, N1, N2)
    oh = [jax.nn.one_hot(i, n) for i, n in zip(idx, (N1, N1, N2, N2))]
    tol = jnp.full((P,), 1e-6)
    pc = (1.0 / diag).reshape(P, -1)

    def solve_with(fused, scale):
        Ts = jnp.asarray(T) * scale

        def matvec(y):
            Y = y.reshape(P, N1, N2)
            G = jnp.einsum('cen,cnk->cek', oh[1], Y)
            Z = Ts * jnp.einsum('cek,cfk->cef', G, oh[3])
            U = jnp.einsum('cef,cei->cif', Z, oh[0])
            out = jnp.einsum('cif,cfk->cik', U, oh[2])
            return (diag * Y - out).reshape(P, -1)
        impl = fused_pcg_solver(Ts, *idx, diag, 1.0 / diag, tol,
                                256) if fused else None
        return solve_linear(matvec, jnp.asarray(b).reshape(P, -1), pc,
                            tol, 256, solve_impl=impl)

    for f in (jax.grad, lambda g: jax.jacfwd(g)):
        d_fused = f(lambda s: jnp.sum(solve_with(True, s) ** 2))(1.0)
        d_xla = f(lambda s: jnp.sum(solve_with(False, s) ** 2))(1.0)
        assert np.allclose(d_fused, d_xla, rtol=1e-4)
    sv = fused_pcg_solver(jnp.asarray(T), *idx, diag, 1.0 / diag, tol,
                          256)
    bs = jnp.stack([jnp.asarray(b).reshape(P, -1) * s for s in (1, 2)])
    xs = jax.vmap(sv)(bs)
    x1 = pcg(lambda y: y, bs[0], pc, tol, 1)  # shape witness only
    assert xs.shape == (2,) + x1.shape
    assert np.allclose(xs[1], 2 * xs[0], rtol=1e-5, atol=1e-7)


def test_pallas_solver_vmem_fallback(interpreted_pallas):
    """The fused kernel's size rule: a pair whose working set exceeds one
    block's shared memory keeps the XLA solve (the kernel is never
    called for it), while molecule-sized pairs fit; union packing for
    'pallas' stops at the largest factor that fits."""
    import jax.numpy as jnp
    from graphdot_tpu.inference import GramFactory
    from graphdot_tpu.ops import pallas_pcg
    from graphdot_tpu.ops.pallas_pcg import fits, fused_bytes, SMEM_BYTES
    from graphdot_tpu.testing import random_molecule_set

    assert fits(64, 64, 24, 24)                 # molecules
    assert not fits(1696, 1696, 304, 304)       # 300-residue proteins
    # padded to powers of two >= 16
    assert fused_bytes(20, 20, 9, 9) == fused_bytes(32, 32, 16, 16)
    assert fused_bytes(128, 128, 32, 32) > SMEM_BYTES

    calls = []
    real = pallas_pcg.fused_pcg_solver

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    mols = random_molecule_set(4, 3, n_atoms_range=(6, 10))
    knode = TensorProduct(element=KroneckerDelta(0.2))
    kedge = TensorProduct(length=SquareExponential(0.3))
    kp = MarginalizedGraphKernel(knode, kedge, q=0.05, backend='pallas')
    ke = MarginalizedGraphKernel(knode, kedge, q=0.05, backend='edge')
    import graphdot_tpu.kernel.marginalized._solver as S
    try:
        S.fused_pcg_solver = spy
        fp = GramFactory(kp, mols, union=False)
        t0 = jnp.asarray(fp.theta0, jnp.float32)
        K_small = np.asarray(fp.gram(t0))
        assert calls                            # fits -> fused kernel
        calls.clear()
        S.fits = lambda *dims: False            # a budget nothing fits
        fp_big = GramFactory(kp, mols, union=False)
        K_big = np.asarray(fp_big.gram(t0))
        assert not calls                        # -> XLA edge solve
    finally:
        S.fused_pcg_solver = real
        S.fits = fits
    K_edge = np.asarray(GramFactory(ke, mols, union=False).gram(t0))
    assert np.allclose(K_small, K_edge, rtol=1e-5, atol=1e-6)
    assert np.allclose(K_big, K_edge, rtol=1e-6, atol=1e-7)

    # union factor: edge packs molecules 8 to a union, the fused kernel
    # only as far as the shared-memory budget allows
    mols = random_molecule_set(5, 16, n_atoms_range=(12, 16))
    fe = GramFactory(ke, mols)
    fk = GramFactory(kp, mols)
    ke_k = max(g['k1'] for g in fe._groups)
    kp_k = max(g['k1'] for g in fk._groups) if fk._groups else 1
    assert ke_k == 8 and kp_k < ke_k
    for g in fk._groups or ():
        m = g['batch1']['esrc'].shape[1]
        assert fits(m, m, g['k1'] * g['ca'], g['k1'] * g['ca'])


def test_pallas_off_gpu_raises():
    """'pallas' without a GPU is an error, never a silent interpreter
    run."""
    from graphdot_tpu.kernel.marginalized._backend import Backend
    with pytest.raises(RuntimeError, match='NVIDIA GPU'):
        MarginalizedGraphKernel(Constant(1.0), Constant(1.0),
                                backend='pallas')
    with pytest.raises(RuntimeError, match='NVIDIA GPU'):
        Backend('pallas')


def test_pallas_vmap_over_theta(interpreted_pallas):
    """vmap(value_and_grad) of a GP log-likelihood over a batch of
    hyperparameters, the way NUTS chains drive it: the fused kernel,
    batched through ``pallas_call``'s batching rule, agrees with the XLA
    edge solver."""
    import jax
    import jax.numpy as jnp
    from graphdot_tpu.inference import GPRLogProb
    from graphdot_tpu.testing import random_molecule_set

    graphs = random_molecule_set(3, 4, n_atoms_range=(8, 12))
    y = np.random.default_rng(0).normal(size=4)
    knode = TensorProduct(element=KroneckerDelta(0.2))
    kedge = TensorProduct(length=SquareExponential(0.3))

    def lp(be):
        k = MarginalizedGraphKernel(knode, kedge, q=0.05, backend=be)
        return GPRLogProb(k, graphs, y, alpha=1e-2)

    lpp, lpe = lp('pallas'), lp('edge')
    t0 = jnp.asarray(lpp.theta0, jnp.float32)
    qs = t0[None, :] + 0.01 * jax.random.normal(
        jax.random.PRNGKey(0), (3, t0.shape[0]))
    vp, gp = jax.vmap(jax.value_and_grad(lpp))(qs)
    ve, ge = jax.vmap(jax.value_and_grad(lpe))(qs)
    assert np.allclose(vp, ve, rtol=1e-4, atol=1e-4)
    assert np.allclose(gp, ge, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize('platform, mode', [('cpu', 'edge'),
                                            ('gpu', None)])
def test_auto_backend_resolution(monkeypatch, tmp_path, platform, mode):
    """'auto' resolves to the measured GPU winner on a GPU (and turns the
    compilation cache on there) and to 'edge' elsewhere."""
    import jax
    from graphdot_tpu.kernel.marginalized import _backend
    from graphdot_tpu.util import compile_cache
    enabled = []
    monkeypatch.setattr(jax, 'default_backend', lambda: platform)
    monkeypatch.setattr(compile_cache, 'enable_compilation_cache',
                        lambda: enabled.append(True))
    b = _backend.backend_factory('auto')
    assert b.mode == (mode or _backend.GPU_MODE)
    assert bool(enabled) == (platform == 'gpu')


def test_bucketed_cross_similarity():
    """Bucketed solving also covers rectangular X-vs-Y job lists
    (class partition spans both graph sets)."""
    from graphdot_tpu.testing import random_molecule_set
    X = random_molecule_set(1, 6, n_atoms_range=(5, 24))
    Y = random_molecule_set(2, 5, n_atoms_range=(5, 24))
    knode = TensorProduct(element=KroneckerDelta(0.2))
    kedge = TensorProduct(length=SquareExponential(0.3))
    k_flat = MarginalizedGraphKernel(knode, kedge, q=0.05)
    k_buck = MarginalizedGraphKernel(knode, kedge, q=0.05, buckets=True)
    R1 = k_flat(X, Y)
    R2 = k_buck(X, Y)
    assert R1.shape == (6, 5)
    assert np.allclose(R1, R2, rtol=1e-4, atol=1e-5)
    Rn1 = k_flat(X, Y, nodal=True)
    Rn2 = k_buck(X, Y, nodal=True)
    assert np.allclose(Rn1, Rn2, rtol=1e-4, atol=1e-5)


def test_kron_backend_matches_edge():
    """The sum-of-Kronecker solver (Chebyshev-factorized edge kernel,
    dense node-space matvec) agrees with the XLA edge backend on
    contact-map graphs, including gradients."""
    from graphdot_tpu.testing import random_protein_set
    import jax
    import jax.numpy as jnp
    from graphdot_tpu.inference import GramFactory

    graphs = random_protein_set(7, 3, n_residues_range=(30, 50))
    knode = TensorProduct(element=KroneckerDelta(0.2))
    kedge = TensorProduct(length=SquareExponential(3.0))

    def build(be):
        k = MarginalizedGraphKernel(knode, kedge, q=0.05, backend=be)
        return GramFactory(k, graphs, normalize=True, buckets=False)

    fk, fe = build('kron'), build('edge')
    t0 = jnp.asarray(fk.theta0, dtype=jnp.float32)
    Kk = np.asarray(jax.jit(fk.gram)(t0))
    Ke = np.asarray(jax.jit(fe.gram)(t0))
    assert np.allclose(Kk, Ke, rtol=1e-4, atol=1e-4)

    # auto-rank calibration engaged at factory construction (kron
    # backend + eligible scalar features); gradients through the
    # calibrated factorization agree with the edge backend to 5e-3
    assert fk._kron_ranks is not None
    gk = np.asarray(jax.grad(lambda t: jnp.sum(fk.gram(t) ** 2))(t0))
    ge = np.asarray(jax.grad(lambda t: jnp.sum(fe.gram(t) ** 2))(t0))
    assert np.allclose(gk, ge, rtol=5e-3, atol=5e-3)

    # iteration instrument works through the kron path
    stats = fk.iteration_stats(t0, mode='kron')
    assert stats[0]['iters'].min() >= 1


def test_kron_fused_matches_sequential(monkeypatch):
    """The fused two-matmul rank contraction is numerically equivalent
    to the sequential rank loop it replaced."""
    from graphdot_tpu.testing import random_protein_set
    import jax
    import jax.numpy as jnp
    from graphdot_tpu.inference import GramFactory

    graphs = random_protein_set(11, 3, n_residues_range=(25, 40))
    knode = TensorProduct(element=KroneckerDelta(0.2))
    kedge = TensorProduct(length=SquareExponential(3.0))

    def gram(fused):
        monkeypatch.setenv('GRAPHDOT_KRON_FUSED', fused)
        k = MarginalizedGraphKernel(knode, kedge, q=0.05,
                                    backend='kron')
        f = GramFactory(k, graphs, normalize=True, buckets=False)
        t0 = jnp.asarray(f.theta0, dtype=jnp.float32)
        return np.asarray(jax.jit(f.gram)(t0))

    assert np.allclose(gram('1'), gram('0'), rtol=1e-6, atol=1e-6)


def test_kron_multi_feature_matches_edge():
    """Tensor-grid Chebyshev: edge kernels over TWO scalar features
    (e.g. TensorProduct(length=..., sep=...)) are kron-eligible and
    agree with the edge backend."""
    from graphdot_tpu.graph import Graph
    from graphdot_tpu.testing import random_protein_set
    import jax
    import jax.numpy as jnp
    from graphdot_tpu.inference import GramFactory

    rng = np.random.default_rng(5)
    graphs = []
    for g in random_protein_set(5, 3, n_residues_range=(20, 30)):
        e = g.edges
        sep = np.abs(np.asarray(e['!i']) - np.asarray(e['!j'])
                     ).astype(np.float32)
        graphs.append(Graph(
            nodes=g.nodes,
            edges={'!i': e['!i'], '!j': e['!j'], '!w': e['!w'],
                   'length': e['length'], 'sep': sep},
            title=g.title))
    knode = TensorProduct(element=KroneckerDelta(0.2))
    kedge = TensorProduct(length=SquareExponential(3.0),
                          sep=SquareExponential(8.0))

    def build(be):
        k = MarginalizedGraphKernel(knode, kedge, q=0.05, backend=be)
        return GramFactory(k, graphs, normalize=True, buckets=False)

    fk, fe = build('kron'), build('edge')
    assert fk._kron_ranks is not None and len(fk._kron_ranks) == 2
    t0 = jnp.asarray(fk.theta0, dtype=jnp.float32)
    Kk = np.asarray(jax.jit(fk.gram)(t0))
    Ke = np.asarray(jax.jit(fe.gram)(t0))
    assert np.allclose(Kk, Ke, rtol=1e-4, atol=1e-4)


def test_kron_rank_calibration():
    """`calibrate_ranks` consumes the factorization-error diagnostic:
    a smooth kernel settles on a small grid, a sharper one escalates,
    and the chosen rank actually meets the tolerance."""
    import jax.numpy as jnp
    from graphdot_tpu.kernel.marginalized._kron import (
        calibrate_ranks, factorization_error
    )
    from graphdot_tpu.kernel.marginalized._solver import (
        _apply_on_features
    )

    kedge = TensorProduct(length=SquareExponential(3.0))
    rng = np.random.default_rng(0)
    x1 = jnp.asarray(rng.uniform(2, 29, (4, 64)).astype(np.float32))
    x2 = jnp.asarray(rng.uniform(2, 29, (4, 64)).astype(np.float32))
    w = jnp.ones((4, 64), dtype=jnp.float32)

    smooth, err_s = calibrate_ranks(
        _apply_on_features, kedge, jnp.asarray([3.0], jnp.float32),
        {'length': x1}, w, {'length': x2}, w)
    sharp, err_h = calibrate_ranks(
        _apply_on_features, kedge, jnp.asarray([1.5], jnp.float32),
        {'length': x1}, w, {'length': x2}, w)
    assert sharp[0] > smooth[0]
    assert err_h < 5e-6
    err = factorization_error(
        _apply_on_features, kedge, jnp.asarray([1.5], jnp.float32),
        {'length': x1}, w, {'length': x2}, w, ranks=sharp)
    assert float(err) < 5e-6

    # a discontinuous edge factor cannot be interpolated: calibration
    # reports a large error (the auto-switch then rejects the kron
    # path — see GramFactory)
    import warnings as _w
    kdelta = TensorProduct(length=KroneckerDelta(0.5))
    with _w.catch_warnings():
        _w.simplefilter('ignore')
        _, err_d = calibrate_ranks(
            _apply_on_features, kdelta,
            jnp.asarray([0.5], jnp.float32),
            {'length': jnp.round(x1)}, w, {'length': jnp.round(x2)},
            w, candidates=(8, 16))
    assert err_d > 1e-4


def test_kron_factorization_error_diagnostic():
    """The runtime Chebyshev-factorization diagnostic reports ~machine
    eps for a smooth kernel over the data range."""
    import jax.numpy as jnp
    from graphdot_tpu.kernel.marginalized._kron import (
        factorization_error
    )
    from graphdot_tpu.kernel.marginalized._solver import (
        _apply_on_features
    )

    kedge = TensorProduct(length=SquareExponential(3.0))
    te = jnp.asarray([3.0], dtype=jnp.float32)
    rng = np.random.default_rng(0)
    x1 = jnp.asarray(rng.uniform(2, 9, (4, 64)).astype(np.float32))
    x2 = jnp.asarray(rng.uniform(2, 9, (4, 64)).astype(np.float32))
    w = jnp.ones((4, 64), dtype=jnp.float32)
    err = factorization_error(
        _apply_on_features, kedge, te, {'length': x1}, w,
        {'length': x2}, w)
    assert float(err) < 1e-5


def test_api_union_routing_matches_per_pair_path():
    """Large non-nodal ``__call__``s route through the
    union-packed GramFactory machinery; the routed path must agree with
    the per-pair path on values, gradients, rectangular calls, and
    after graph mutation (cookie invalidation)."""
    import os
    from graphdot_tpu.testing import random_molecule_set

    mols = random_molecule_set(5, 12, n_atoms_range=(5, 16))
    X, Y = mols[:7], mols[7:]
    k = MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(0.3)), q=0.05)
    old = os.environ.get('GRAPHDOT_API_UNION')
    try:
        os.environ['GRAPHDOT_API_UNION'] = '0'
        K0, dK0 = k(X, eval_gradient=True)
        C0 = k(X, Y)
        os.environ['GRAPHDOT_API_UNION'] = '1'  # force for small sets
        K1, dK1 = k(X, eval_gradient=True)
        C1 = k(X, Y)
        assert np.allclose(K1, K0, rtol=1e-4, atol=1e-4)
        assert np.allclose(
            dK1, dK0, rtol=1e-3,
            atol=1e-3 * max(1.0, float(np.max(np.abs(dK0)))))
        assert np.allclose(C1, C0, rtol=1e-4, atol=1e-4)
        # cached factories must invalidate when a graph mutates
        g = X[0].permute(
            np.random.default_rng(0).permutation(len(X[0].nodes)))
        K2 = k([g] + X[1:])
        assert np.allclose(K2, K0, rtol=1e-4, atol=1e-4)
    finally:
        if old is None:
            os.environ.pop('GRAPHDOT_API_UNION', None)
        else:
            os.environ['GRAPHDOT_API_UNION'] = old
