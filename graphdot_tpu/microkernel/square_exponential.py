"""Square-exponential (Gaussian/RBF) microkernel."""
from ._scalar import SquareExponential  # noqa: F401
