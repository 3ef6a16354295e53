"""Sharded Gram-matrix construction over a device mesh.

The reference schedules independent graph-pair jobs across thread blocks
with a global atomic counter (``template.cu:57-63``); across devices the
job list becomes a static partition of the upper-triangular pair index
set over the mesh, solved locally by the batched CG and reassembled with
an all-gather (implicit in the shard_map output spec).

Size-bucketed factories (``GramFactory(buckets='auto')``, the default for
heterogeneous graph sets) are supported directly: each size-class pair
group keeps its own padded shapes and its job list is sharded over the
mesh independently, so every device works on every size class — the
static-partition analogue of the reference's dynamic load balancing.

By default jobs are sharded over ALL mesh axes (``axis=None``): a
standalone Gram build on a {'pairs': 4, 'chains': 2} mesh uses all 8
devices instead of duplicating work along the chains axis. Pass an axis
name (or tuple) to restrict the job sharding, e.g. when other axes carry
other work.

When the factory holds precomputed incidence one-hots (the usual case
within the one-hot memory budget), they are placed sharded along the job
axis, straight from the host, and passed into each shard's solve rather
than being rebuilt in-trace on every device. No device holds them all.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

_OH_KEYS = ('oh_src_1', 'oh_dst_1', 'oh_src_2', 'oh_dst_2')


def sharded_gram_fn(factory, mesh, axis=None, lmin=0):
    """Build a jitted ``theta_log_active -> K`` over the mesh, with pair
    jobs sharded along ``axis`` (default: all mesh axes).

    Parameters
    ----------
    factory: :class:`graphdot_tpu.inference.gram.GramFactory`
    mesh: jax.sharding.Mesh.
    axis: None | str | tuple of str
        Mesh axes to shard the job list over. None uses every axis.
    """
    if getattr(factory, '_two', False):
        raise NotImplementedError(
            'sharded_gram_fn supports symmetric factories only; shard '
            'a rectangular cross-Gram by splitting the row graphs '
            'across factories instead.')
    n = factory._n
    if axis is None:
        axis = tuple(mesh.axis_names)
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n_dev = int(np.prod([mesh.shape[a] for a in axes]))
    spec = P(axes)

    node_counts = np.array(
        [len(g.nodes) for g in factory.graphs], dtype=np.float32)

    if factory._groups is not None:
        raw_groups = [
            dict(
                batch1=grp['batch1'], batch2=grp['batch2'],
                pfix1=grp['pfix1'], pfix2=grp['pfix2'],
                gi=np.asarray(grp['gi']), gj=np.asarray(grp['gj']),
                idx1=np.asarray(grp['idx1']),
                idx2=np.asarray(grp['idx2']),
                tol_n1=np.asarray(grp['tol_n1']),
                tol_n2=np.asarray(grp['tol_n2']),
                k1=grp['k1'], k2=grp['k2'],
                ca=grp['ca'], cb=grp['cb'],
                onehots=grp['onehots'],
                maxiter=factory._group_maxiter(grp),
            )
            for grp in factory._groups
        ]
    else:
        iu, ju = np.triu_indices(n)
        raw_groups = [dict(
            batch1=factory._batch, batch2=factory._batch,
            pfix1=factory._p_fixed, pfix2=factory._p_fixed,
            gi=iu, gj=ju, idx1=iu, idx2=ju,
            tol_n1=node_counts[iu], tol_n2=node_counts[ju],
            k1=1, k2=1, ca=factory._n_pad, cb=factory._n_pad,
            onehots=factory._onehots,
            maxiter=min(factory._n_pad * factory._n_pad,
                        factory._maxiter_cap),
        )]

    groups = []
    for grp in raw_groups:
        n_jobs = len(grp['idx1'])
        pad = (-n_jobs) % n_dev
        k1, k2 = grp['k1'], grp['k2']
        gi = grp['gi'].reshape(n_jobs, k1)
        gj = grp['gj'].reshape(n_jobs, k2)
        # phantom members and padded jobs scatter into row/col n of the
        # (n+1)-padded Gram, which is discarded
        gi = np.concatenate(
            [np.where(gi < 0, n, gi), np.full((pad, k1), n)])
        gj = np.concatenate(
            [np.where(gj < 0, n, gj), np.full((pad, k2), n)])

        def _pad_idx(a):
            return jnp.asarray(
                np.concatenate([a, np.zeros(pad, dtype=a.dtype)])
                .astype(np.int32)
            )

        def _pad_tol(a, fill):
            # pad with the class node count so padded jobs (which
            # re-solve job 0's system when one-hots are rebuilt
            # in-trace) face a reachable tolerance — padding with 1.0
            # would set an absolute tol of ~ftol that f32 CG cannot
            # hit, stalling the shard at maxiter
            return jnp.asarray(np.concatenate(
                [a, np.full(pad, fill)]).astype(np.float32))

        # precomputed per-job one-hots shard along the job axis; padded
        # jobs get zero rows (their results are discarded below)
        oh = grp['onehots']
        has_oh = all(k in oh for k in _OH_KEYS)
        oh_args = tuple(
            jax.device_put(
                np.pad(np.asarray(oh[k]),
                       [(0, pad)] + [(0, 0)] * (oh[k].ndim - 1)),
                NamedSharding(mesh, spec))
            for k in _OH_KEYS
        ) if has_oh else ()

        tile = (k1, grp['ca'], k2, grp['cb'])
        solver = shard_map(
            partial(
                factory._group_ops_solve, grp['batch1'], grp['batch2'],
                grp['pfix1'], grp['pfix2'], lmin, grp['maxiter'], tile
            ),
            mesh=mesh,
            in_specs=(P(), spec, spec, spec, spec)
            + (spec,) * len(oh_args),
            out_specs=spec,
            check_vma=False,
        )
        groups.append(dict(
            solver=solver, n_jobs=n_jobs,
            idx1=_pad_idx(grp['idx1']), idx2=_pad_idx(grp['idx2']),
            tol_n1=_pad_tol(grp['tol_n1'], grp['ca']),
            tol_n2=_pad_tol(grp['tol_n2'], grp['cb']),
            oh_args=oh_args,
            gi=jnp.asarray(gi.astype(np.int32)),
            gj=jnp.asarray(gj.astype(np.int32)),
        ))

    @jax.jit
    def gram(theta_log_active):
        theta = factory.full_theta(theta_log_active)
        Kp = jnp.zeros((n + 1, n + 1), dtype=jnp.float32)
        for grp in groups:
            r = grp['solver'](
                theta, grp['idx1'], grp['idx2'],
                grp['tol_n1'], grp['tol_n2'], *grp['oh_args'])
            gi = grp['gi'][:, :, None]       # [S_pad, k1, 1]
            gj = grp['gj'][:, None, :]       # [S_pad, 1, k2]
            Kp = Kp.at[gi, gj].set(r)
            Kp = Kp.at[gj, gi].set(r)
        K = Kp[:n, :n]
        if factory.normalize:
            d = jnp.sqrt(jnp.diagonal(K))
            K = K / d[:, None] / d[None, :]
        return K

    return gram
