"""Marginalized graph kernel evaluated at an explicit list of graph-index
pairs (reference: ``graphdot/experimental/alterantive_mgk/_kernel.py:11``).

Here this is a thin specialization: the batched solver already
consumes arbitrary job lists, so no separate backend is needed.
"""
import numpy as np

from ..graph import Graph
from ..kernel.marginalized import MarginalizedGraphKernel


class AltMarginalizedGraphKernel(MarginalizedGraphKernel):
    """Evaluates K only at the requested (i, j) pairs.

    Parameters are inherited from MarginalizedGraphKernel.
    """

    def __call__(self, X, ij, lmin=0, timing=False):
        """Compute a vector of similarities for the given pair indices.

        Parameters
        ----------
        X: list of N graphs with identical feature signatures.
        ij: list of (i, j) int pairs into X.
        lmin: 0 or 1.

        Returns
        -------
        gramian: 1-D ndarray with the same length as ij.
        """
        pred_or_tuple = Graph.has_unified_types(X)
        if pred_or_tuple is not True:
            group, first, second = pred_or_tuple
            raise TypeError(
                f'The two graphs have mismatching {group} attributes or '
                'attribute types. Try `Graph.unify_datatype`.\n'
                f'First graph: {first}\nSecond graph: {second}\n'
            )
        ij = np.asarray(ij, dtype=np.int64)
        raw = self._solve_jobs(
            list(X), ij[:, 0], ij[:, 1], nodal=False, lmin=lmin,
            eval_gradient=False
        )
        return np.asarray(raw).astype(self.element_dtype)
