"""Node reordering strategies (reference: ``graphdot/graph/reorder/``).

Reordering reduces the number of non-empty tiles in the blocked adjacency
layout consumed by the solver — the analogue of the reference's
octile-count minimization for its CUDA kernel.
"""
from .rcm import rcm
from .pbr import pbr

__all__ = ['rcm', 'pbr']
