"""GraphDot in JAX: marginalized graph kernels and Gaussian-process
models on graphs.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
reference GraphDot library (marginalized graph kernels via generalized-
Kronecker product-graph solves, GPR/Nystrom models, graph metrics, active
learning), plus a Bayesian inference layer (NUTS/HMC/SMC/VI over kernel
hyperparameters) and multi-chip sharding over ``jax.sharding.Mesh``.
"""
from .graph import Graph

__version__ = '0.3.0'
__all__ = ['Graph']
