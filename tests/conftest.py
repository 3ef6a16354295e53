"""Test configuration: run JAX on a virtual 8-device CPU mesh so that both
numerics and multi-device sharding paths are exercised without a GPU
(SURVEY.md §4.8).

Tests marked ``gpu`` need an NVIDIA GPU; the ``gpu`` fixture skips them
elsewhere. To run them on a card, select the GPU backend explicitly:
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""
import functools
import os

import jax
import pytest

if os.environ.get('JAX_PLATFORMS', '').lower() not in ('cuda', 'gpu'):
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_num_cpu_devices', 8)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is an NVIDIA GPU."""
    if jax.default_backend() != 'gpu':
        pytest.skip('needs an NVIDIA GPU; on a card run '
                    'JAX_PLATFORMS=cuda python -m pytest -m gpu tests/')


@pytest.fixture
def interpreted_pallas(monkeypatch):
    """Run ``backend='pallas'`` and the fused kernel on any host: every
    ``pallas_call`` goes through the Pallas interpreter, and the backend
    check sees a GPU. The library itself has no interpreter path. The
    traces made here are dropped afterwards, so that no later test reuses
    an interpreted program."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(jax, 'default_backend', lambda: 'gpu')
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    yield
    jax.clear_caches()
