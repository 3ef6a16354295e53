"""What the package needs from its platform: device peaks by card, the
compilation cache's location, its dependencies, and (marked ``gpu``)
the fused kernel compiled for the card."""
import os
import subprocess
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_peak_flops_h100():
    from graphdot_tpu.util.flops import device_peak_flops
    h100 = types.SimpleNamespace(device_kind='NVIDIA H100 80GB HBM3')
    assert device_peak_flops(h100) == 495e12
    assert device_peak_flops(h100, 'bf16') == 989e12
    assert device_peak_flops(h100, 'fp32') == 67e12


@pytest.mark.parametrize('kind', ['NVIDIA A100-SXM4-80GB', 'cpu', None])
def test_device_peak_flops_unknown_kind_raises(kind):
    """A device without a peak on record is an error, not a default."""
    from graphdot_tpu.util.flops import device_peak_flops
    with pytest.raises(KeyError, match='no peak FLOP/s'):
        device_peak_flops(types.SimpleNamespace(device_kind=kind))


@pytest.mark.parametrize('env', [None, 'given'])
def test_compilation_cache_dir(monkeypatch, tmp_path, env):
    """JAX_COMPILATION_CACHE_DIR wins and is left to JAX to read;
    otherwise the cache lives in a fixed, gitignored directory of the
    checkout."""
    import jax
    from graphdot_tpu.util import compile_cache
    updates = {}
    monkeypatch.setattr(jax.config, 'update',
                        lambda k, v: updates.__setitem__(k, v))
    if env is None:
        monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
        monkeypatch.setattr(compile_cache, 'DEFAULT_DIR',
                            str(tmp_path / 'cache'))
        want = str(tmp_path / 'cache')
        assert compile_cache.enable_compilation_cache() == want
        assert updates['jax_compilation_cache_dir'] == want
        assert os.path.isdir(want)
    else:
        monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
        assert compile_cache.enable_compilation_cache() == str(tmp_path)
        assert 'jax_compilation_cache_dir' not in updates
    assert 'jax_persistent_cache_min_compile_time_secs' in updates


def test_default_cache_dir_is_gitignored():
    from graphdot_tpu.util.compile_cache import DEFAULT_DIR
    assert os.path.dirname(DEFAULT_DIR) == ROOT
    with open(os.path.join(ROOT, '.gitignore')) as f:
        ignored = f.read().split()
    assert os.path.basename(DEFAULT_DIR) + '/' in ignored


def test_main_path_without_optional_packages():
    """The main import path, and a Gram build on it, need only numpy,
    scipy, jax and optax: sympy, networkx and pandas are blocked."""
    code = '''
import sys
class Block:
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ('sympy', 'networkx', 'pandas'):
            raise ImportError('blocked ' + name)
sys.meta_path.insert(0, Block())
import jax
jax.config.update('jax_platforms', 'cpu')
import graphdot_tpu, graphdot_tpu.graph, graphdot_tpu.microkernel
import graphdot_tpu.kernel, graphdot_tpu.inference, graphdot_tpu.parallel
import graphdot_tpu.model.gaussian_process, graphdot_tpu.testing
from graphdot_tpu.inference import GramFactory
from graphdot_tpu.kernel import MarginalizedGraphKernel
from graphdot_tpu.microkernel import (
    KroneckerDelta, RationalQuadratic, SquareExponential, TensorProduct)
from graphdot_tpu.testing import random_molecule_set
for kedge in (SquareExponential(0.3), RationalQuadratic(0.3, 2.0)):
    k = MarginalizedGraphKernel(TensorProduct(element=KroneckerDelta(0.2)),
                                TensorProduct(length=kedge), q=0.05)
    f = GramFactory(k, random_molecule_set(0, 4, n_atoms_range=(5, 9)))
    K = f.gram(jax.numpy.asarray(f.theta0))
    assert K.shape == (4, 4) and bool(jax.numpy.all(K > 0))
print('OK')
'''
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith('OK')


def test_card_description_needs_a_gpu():
    """Bench numbers carry the card they ran on; a host without a GPU
    is refused rather than timed."""
    from graphdot_tpu.util.card import describe
    with pytest.raises(RuntimeError, match='no GPU'):
        describe()
    d = describe(require_gpu=False)
    assert d['platform'] == 'cpu' and d['count'] == 8
    assert 'nvidia_smi' not in d


def _mols_and_kernel(backend):
    from graphdot_tpu.kernel import MarginalizedGraphKernel
    from graphdot_tpu.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    from graphdot_tpu.testing import random_molecule_set
    return random_molecule_set(42, 24, n_atoms_range=(9, 24)), \
        MarginalizedGraphKernel(
            TensorProduct(element=KroneckerDelta(0.2)),
            TensorProduct(length=SquareExponential(0.3)),
            q=0.05, backend=backend)


@pytest.mark.gpu
def test_fused_kernel_on_gpu_matches_edge(gpu):
    """The fused kernel compiled for the card (no interpreter) agrees
    with the XLA edge solver in values and theta-gradients."""
    import jax
    import jax.numpy as jnp
    from graphdot_tpu.inference import GramFactory
    graphs, kp = _mols_and_kernel('pallas')
    _, ke = _mols_and_kernel('edge')
    fp, fe = GramFactory(kp, graphs), GramFactory(ke, graphs)
    t0 = jnp.asarray(fp.theta0, jnp.float32)
    assert np.allclose(fp.gram(t0), fe.gram(t0), rtol=1e-5, atol=1e-6)
    gp, ge = (jax.grad(lambda t, f=f: jnp.sum(f.gram(t) ** 2))(t0)
              for f in (fp, fe))
    assert np.allclose(gp, ge, rtol=1e-3, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize('backend', ['auto', 'edge'])
def test_precision_contract_on_gpu(gpu, backend):
    """On the card, the solver meets the float64 oracle at rel 1e-4
    (the CPU tests' tolerance for the same path)."""
    import jax.numpy as jnp
    from graphdot_tpu.inference import GramFactory
    from oracle import mlgk
    graphs, k = _mols_and_kernel(backend)
    graphs = graphs[:8]
    f = GramFactory(k, graphs, normalize=False)
    K = np.asarray(f.gram(jnp.asarray(f.theta0, jnp.float32)))
    for i in range(8):
        for j in range(i, 8):
            want = mlgk(graphs[i], graphs[j], k.node_kernel,
                        k.edge_kernel, 0.05)
            assert abs(K[i, j] - want) <= 1e-4 * abs(want)
