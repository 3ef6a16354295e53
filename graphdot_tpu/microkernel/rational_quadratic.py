"""Rational-quadratic microkernel."""
from ._scalar import RationalQuadratic  # noqa: F401
