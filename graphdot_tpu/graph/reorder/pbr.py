"""Partition-based reordering to minimize non-empty tiles.

The reference implements PBR via recursive hypergraph bisection with
KaHyPar (``graphdot/graph/reorder/pbr/mnom.py:11,296``); this build
ships a dependency-free reimplementation of the same MNOM algorithm
(:mod:`.mnom`: column-net hypergraph, exact tile-aligned bisection
targets, message nets) and additionally races it against identity, RCM,
and a spectral ordering, returning whichever yields the fewest nonempty
TILE x TILE blocks — the quantity that governs the solver's matvec
cost.
"""
import numpy as np
import scipy.sparse
import scipy.sparse.csgraph

from .mnom import PbrMnom


def _tile_count(A, perm, tile=8):
    """Number of non-empty tile x tile blocks after permuting A."""
    A = A.tocoo()
    ip = np.argsort(perm)
    i = ip[A.row] // tile
    j = ip[A.col] // tile
    return len(set(zip(i.tolist(), j.tolist())))


def _spectral_perm(A):
    """Order nodes by the Fiedler vector of the graph Laplacian."""
    n = A.shape[0]
    if n <= 2:
        return np.arange(n)
    L = scipy.sparse.csgraph.laplacian(A.astype(float), normed=True)
    if n <= 4096:
        vals, vecs = np.linalg.eigh(np.asarray(L.todense()))
        return np.argsort(vecs[:, np.argsort(vals)[1]])
    try:
        vals, vecs = scipy.sparse.linalg.eigsh(
            L, k=2, sigma=0, which='LM', maxiter=5000
        )
        fiedler = vecs[:, np.argsort(vals)[1]]
        return np.argsort(fiedler)
    except Exception:
        return np.arange(n)


def pbr(g, tile=8):
    """Compute a tile-count-minimizing permutation of a graph.

    Parameters
    ----------
    g: Graph
        The graph to be reordered.
    tile: int
        The tile size of the blocked adjacency layout.

    Returns
    -------
    perm: numpy.ndarray
        Array of permuted node indices; pass to ``Graph.permute``.
    """
    A = g.adjacency_matrix.tocsr()
    coo = A.tocoo()
    candidates = [
        np.arange(A.shape[0]),
        scipy.sparse.csgraph.reverse_cuthill_mckee(A, symmetric_mode=True),
        _spectral_perm(A),
        PbrMnom(tilesize=tile)(coo.row, coo.col, A.shape[0], A.shape[1]),
    ]
    counts = [_tile_count(A, p, tile) for p in candidates]
    return np.asarray(candidates[int(np.argmin(counts))])
