"""Multi-process smoke test of the distributed bootstrap
(``parallel.mesh.init_distributed``): two local CPU processes form one
JAX cluster, build a global mesh, and run a cross-process reduction.

This is the single-host emulation of the multi-host path (DCN between
hosts); it validates the coordinator wiring on one machine.
"""
import socket
import subprocess
import sys
import os

_CHILD = r"""
import sys
import jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_num_cpu_devices', 2)

port, pid = sys.argv[1], int(sys.argv[2])
from graphdot_tpu.parallel import init_distributed, make_mesh
init_distributed(f'localhost:{port}', num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.device_count()
assert jax.local_device_count() == 2

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

mesh = make_mesh({'pairs': 4})
sharding = NamedSharding(mesh, P('pairs'))
global_data = np.arange(8, dtype=np.float32)
# each process contributes the rows its local devices own
local = global_data.reshape(4, 2)[pid * 2:(pid + 1) * 2]
arr = jax.make_array_from_process_local_data(
    sharding, local.reshape(-1), global_shape=(8,)
)
total = jax.jit(jnp.sum)(arr)          # cross-process reduction
print('TOTAL', float(total), flush=True)
assert float(total) == 28.0
"""


def test_two_process_cpu_cluster(tmp_path):
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)
    env['PYTHONPATH'] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(__file__))]
        + env.get('PYTHONPATH', '').split(os.pathsep)
    )
    procs = [
        subprocess.Popen(
            [sys.executable, '-c', _CHILD, str(port), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'process {pid} failed:\n{out}'
        assert 'TOTAL 28.0' in out, out
