"""Analytic FLOP model and device peaks for the MLGK solver benches.

The reference's IPDPS'20 artifact is a throughput paper; its CUDA kernel
(``graphdot/cpp/marginalized_kernel.h:61-490``) was evaluated in
FLOP-accounted terms. This module provides the same accounting: an
analytic cost model of the edge-factored PCG matvec, combined with
measured per-pair CG iteration counts (``GramFactory.iteration_stats``),
gives the ``useful`` FLOPs of a Gram build (true graph dimensions, one
pass per contraction), and :func:`device_peak_flops` the peak to divide
a measured rate by.
"""
import numpy as np

#: dense peak FLOP/s by ``device_kind`` and operand precision (NVIDIA
#: H100 Tensor Core GPU data sheet, SXM5, without sparsity; 'fp32' is
#: the CUDA-core rate outside the tensor cores)
PEAK_FLOPS = {
    'NVIDIA H100 80GB HBM3': {
        'bf16': 989e12, 'tf32': 495e12, 'fp32': 67e12,
    },
}


def device_peak_flops(device=None, precision='tf32'):
    """Peak FLOP/s of ``device`` (default: jax.devices()[0]) at
    ``precision`` ('bf16', 'tf32' or 'fp32'). A device kind that is not
    in :data:`PEAK_FLOPS` is an error."""
    if device is None:
        import jax
        device = jax.devices()[0]
    kind = getattr(device, 'device_kind', None)
    if kind not in PEAK_FLOPS:
        raise KeyError(f'no peak FLOP/s on record for device kind '
                       f'{kind!r}; known: {sorted(PEAK_FLOPS)}')
    return PEAK_FLOPS[kind][precision]


def matvec_flops(m1, m2, n1, n2):
    """FLOPs of one edge-factored product-graph matvec at the given
    dims: the four contractions G = D1 Y, H = G D2^T, U = S1^T (T o H),
    out = U S2 (2 FLOPs per MAC)."""
    return 2 * (m1 * n1 * n2 + m1 * m2 * n2 + n1 * m1 * m2
                + n1 * m2 * n2)


def graph_dims(graph):
    """(n_nodes, n_directed_edges) of a Graph — the true dims of its
    side of a pair solve."""
    n = len(graph.nodes)
    i = np.asarray(graph.edges['!i'])
    j = np.asarray(graph.edges['!j'])
    m = int(2 * np.sum(i != j) + np.sum(i == j))
    return n, int(m)


def save_iteration_stats(path, stats):
    """Persist ``GramFactory.iteration_stats`` output to an .npz cache
    (committed fixture: iteration counts are deterministic for a fixed
    workload/theta/ftol, and recomputing them costs several fresh XLA
    compiles that benchmark runs should not pay)."""
    payload = {'n_groups': np.int64(len(stats))}
    for i, grp in enumerate(stats):
        for key in ('iters', 'gi', 'gj'):
            payload[f'g{i}_{key}'] = np.asarray(grp[key])
        payload[f'g{i}_dims'] = np.asarray(
            [grp['ca'], grp['cb'], grp['m1'], grp['m2'],
             grp['n_jobs'], grp.get('k1', 1), grp.get('k2', 1)])
    np.savez_compressed(path, **payload)


def load_iteration_stats(path):
    blob = np.load(path)
    stats = []
    for i in range(int(blob['n_groups'])):
        d = blob[f'g{i}_dims']
        ca, cb, m1, m2, n_jobs = d[:5]
        k1, k2 = (d[5], d[6]) if len(d) > 5 else (1, 1)
        stats.append({
            'ca': int(ca), 'cb': int(cb), 'm1': int(m1),
            'm2': int(m2), 'n_jobs': int(n_jobs),
            'k1': int(k1), 'k2': int(k2),
            'iters': blob[f'g{i}_iters'],
            'gi': blob[f'g{i}_gi'], 'gj': blob[f'g{i}_gj'],
        })
    return stats


def gram_flop_report(factory, theta, stats=None):
    """Useful FLOPs of one Gram build of ``factory`` at ``theta``.

    Returns a dict with ``useful_flops`` and the iteration stats used.
    Pass precomputed ``stats`` (e.g. from :func:`load_iteration_stats`)
    to skip the instrumented solves.
    """
    if stats is None:
        stats = factory.iteration_stats(theta)
    if getattr(factory, '_two', False):
        raise NotImplementedError(
            'gram_flop_report supports symmetric factories only')
    dims = [graph_dims(g) for g in factory.graphs]

    def _2d(a):
        a = np.asarray(a)
        return a[:, None] if a.ndim == 1 else a

    # When ``stats`` came from a union-packed factory, every member pair
    # of a super-pair is charged the (shared) super-pair count — a slight
    # overcount; record the cache with a union=False factory for exact
    # per-pair counts.
    useful = 0.0
    for grp in stats:
        gi2, gj2 = _2d(grp['gi']), _2d(grp['gj'])
        for s, it in enumerate(np.asarray(grp['iters'])):
            for a in gi2[s]:
                if a < 0:
                    continue
                for b in gj2[s]:
                    if b < 0:
                        continue
                    n1, m1 = dims[a]
                    n2, m2 = dims[b]
                    useful += float(it) * matvec_flops(m1, m2, n1, n2)
    return {'useful_flops': useful, 'stats': stats}
