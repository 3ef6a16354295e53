"""Multi-device parallelism: mesh construction, sharded Gram builds, and
chain/particle sharding (SURVEY.md §2.9 equivalents)."""
from .gram import sharded_gram_fn
from .mesh import init_distributed, make_mesh, replicated, sharded_along
from .solve import sharded_cg_solve_fn, sharded_gp_solve

__all__ = [
    'make_mesh', 'replicated', 'sharded_along', 'sharded_gram_fn',
    'init_distributed', 'sharded_cg_solve_fn', 'sharded_gp_solve',
]
