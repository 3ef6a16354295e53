"""Native C++ packer tests (the analogue of the reference's host-side
C++ unit tests, ``test/cpp/``)."""
import numpy as np
import pytest

from graphdot_tpu import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason='no C++ toolchain'
)


def test_pack_batch():
    n_nodes = [3, 2]
    ei = [0, 0, 1, 0]
    ej = [1, 2, 2, 1]
    ew = [1.0, 2.0, 3.0, 0.5]
    offsets = [0, 3, 4]
    adj, deg, mask, esrc, edst, ewo, n_edge = native.pack_batch(
        n_nodes, offsets, ei, ej, ew, n_pad=4, m_pad=8
    )
    assert adj[0][0, 1] == 1.0 and adj[0][2, 0] == 2.0
    assert adj[1][0, 1] == 0.5
    assert np.allclose(deg[0], adj[0].sum(axis=1))
    assert n_edge.tolist() == [6, 2]
    assert mask[0].tolist() == [1, 1, 1, 0]
    # directed list symmetric per edge
    assert esrc[0][0] == 0 and edst[0][0] == 1
    assert esrc[0][1] == 1 and edst[0][1] == 0


def test_pack_batch_self_loop():
    adj, deg, mask, esrc, edst, ewo, n_edge = native.pack_batch(
        [2], [0, 2], [0, 0], [0, 1], [2.0, 1.0], n_pad=8, m_pad=8
    )
    assert adj[0][0, 0] == 2.0
    assert n_edge[0] == 3  # self-loop once + edge both ways
    assert deg[0][0] == 3.0  # 2 (self) + 1


def test_pack_edge_feature():
    offsets = [0, 2]
    mat, elist = native.pack_edge_feature(
        offsets, [0, 1], [1, 2], [10.0, 20.0], 1, 4, 8
    )
    assert mat[0][0, 1] == mat[0][1, 0] == 10.0
    assert mat[0][1, 2] == 20.0
    assert elist[0][:4].tolist() == [10.0, 10.0, 20.0, 20.0]


def test_schedule_jobs():
    n_nodes = np.array([3, 2, 5], dtype=np.int32)
    i_idx = [0, 1, 2, 0]
    j_idx = [0, 1, 2, 2]
    order = native.schedule_jobs(i_idx, j_idx, n_nodes)
    costs = [9, 4, 25, 15]
    assert [costs[k] for k in order] == sorted(costs, reverse=True)


def test_native_matches_python_packing():
    """The native batch must agree with the pure-python pack_graph path
    on dense quantities (adjacency, degrees, features)."""
    import networkx as nx
    from graphdot_tpu import Graph
    from graphdot_tpu.graph.batch import batch_graphs

    rng = np.random.default_rng(0)
    graphs = []
    for i in range(4):
        g = nx.newman_watts_strogatz_graph(6 + i, 3, 0.4, seed=i)
        nx.set_edge_attributes(
            g, {e: float(rng.uniform(1, 2)) for e in g.edges}, 'length'
        )
        nx.set_node_attributes(
            g, {k: float(rng.normal()) for k in g.nodes}, 'x'
        )
        graphs.append(Graph.from_networkx(g))
    graphs = Graph.unify_datatype(graphs)

    b_native = batch_graphs(graphs, use_native=True)
    b_python = batch_graphs(graphs, use_native=False)
    assert np.allclose(b_native.adj, b_python.adj)
    assert np.allclose(b_native.degree, b_python.degree)
    assert np.allclose(b_native.node_mask, b_python.node_mask)
    assert np.allclose(
        b_native.node_feats['x'], b_python.node_feats['x']
    )
    assert np.allclose(
        b_native.edge_feats['length'], b_python.edge_feats['length']
    )
    # directed-edge orderings may differ; compare as multisets
    for b in range(len(graphs)):
        na = sorted(zip(
            b_native.esrc[b][:b_native.n_edge[b]].tolist(),
            b_native.edst[b][:b_native.n_edge[b]].tolist(),
            b_native.ew[b][:b_native.n_edge[b]].tolist(),
        ))
        py = sorted(zip(
            b_python.esrc[b][:b_python.n_edge[b]].tolist(),
            b_python.edst[b][:b_python.n_edge[b]].tolist(),
            b_python.ew[b][:b_python.n_edge[b]].tolist(),
        ))
        assert na == py


def test_library_built_from_source():
    """The library is compiled from packer.cpp under a name keyed by
    the source and the compiler flags, so a changed source or flag set
    never loads a stale build."""
    import os
    path = native._library_path()
    assert os.path.basename(path).startswith('_packer-')
    assert os.path.exists(path)
    flags = native._FLAGS
    try:
        native._FLAGS = flags + ['-DGRAPHDOT_TEST_KEY']
        assert native._library_path() != path
    finally:
        native._FLAGS = flags
