"""Backend selection (reference: ``graphdot/kernel/marginalized/_backend.py``
and ``_backend_factory.py``).

One JAX/XLA engine with four solver modes:

- ``'pallas'``: the fused PCG kernel (``ops/pallas_pcg.py``), one program
  per pair running that pair's whole CG loop on chip, as the reference's
  one-block-per-pair CUDA solver does. Needs an NVIDIA GPU. Pairs whose
  working set exceeds one block's shared memory take ``'edge'``
  (``pallas_pcg.fits``).
- ``'edge'``: edge-factored matvec in XLA, four batched one-hot
  contractions per CG iteration over per-pair edge-kernel matrices.
  O(M1 M2 (n1+n2)) per matvec.
- ``'dense'``: dense product-graph coupling tensor, one contraction per CG
  iteration, O(n1^2 n2^2); the direct transcription of the CPU oracle,
  for validation and tiny graphs.
- ``'kron'``: the sum-of-Kronecker node-space solver for protein-scale
  pairs (``_kron.py``).

``'auto'`` resolves to :data:`GPU_MODE` on a GPU and to ``'edge'``
elsewhere. On an H100 the fused kernel built the 8,256-pair Gram of 128
molecules 7x faster than ``'edge'`` (``PERF.md``, Findings).
"""
import jax


class Backend:
    """Computing engine that solves the marginalized graph kernel's
    generalized Laplacian equation. ``'pallas'`` off a GPU is an
    error."""

    MODES = ('edge', 'dense', 'pallas', 'kron')

    def __init__(self, mode='edge'):
        if mode not in self.MODES:
            raise ValueError(f'Unknown backend mode {mode!r}')
        if mode == 'pallas' and jax.default_backend() != 'gpu':
            raise RuntimeError(
                "backend 'pallas' compiles a Triton kernel and needs an "
                f'NVIDIA GPU; the default JAX backend is '
                f"{jax.default_backend()!r}. Use backend='edge'.")
        self.mode = mode


#: the mode 'auto' resolves to on a GPU: the winner of the end-to-end
#: comparison with 'edge' (``scripts/compare_solvers.py``)
GPU_MODE = 'pallas'


def _auto_mode():
    if jax.default_backend() == 'gpu':
        from ...util.compile_cache import enable_compilation_cache
        enable_compilation_cache()
        return GPU_MODE
    return 'edge'


def backend_factory(backend, **kwargs):
    if isinstance(backend, Backend):
        return backend
    if backend == 'auto':
        return Backend(_auto_mode())
    if backend in Backend.MODES:
        return Backend(backend)
    raise ValueError(f"Unknown backend {backend!r}")
