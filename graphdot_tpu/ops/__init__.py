"""Hand-written GPU kernels (Pallas, Triton route)."""
