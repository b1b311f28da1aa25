"""Example: sharding a huge state batch across a device mesh.

Evaluates analytical Jacobians for a large batch of the flagship
mechanism's states with the batch sharded over all available devices.
Run on a multi-GPU host, or simulate one on CPU:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip_batch.py
"""

import os

if 'xla_force_host_platform_device_count' in os.environ.get(
        'XLA_FLAGS', ''):
    import jax
    jax.config.update('jax_platforms', 'cpu')

import jax  # noqa: E402

jax.config.update('jax_enable_x64', True)

import sys  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from __graft_entry__ import _flagship_packed  # noqa: E402
from pyjac_jax.parallel.mesh import (BatchEvaluator, make_mesh,  # noqa: E402
                                     sharded_step)
from pyjac_jax.testers.synthetic import random_states  # noqa: E402


def main():
    mech, packed = _flagship_packed()
    mesh = make_mesh()
    print('mesh devices:', mesh.devices.size)

    # one fused sharded step (J, dydt, global max-norm across devices)
    step = sharded_step(packed, mesh)
    y, T, P = random_states(mech, 64 * mesh.devices.size, seed=0)
    J, f, norm = step(np.asarray(y), np.asarray(P))
    print('sharded step: J %s sharded as %s; global norm %.3e' %
          (J.shape, J.sharding, float(norm)))

    # chunked evaluation of a batch larger than one dispatch
    ev = BatchEvaluator(packed, mesh, chunk_size=256)
    y_big, _, P_big = random_states(mech, 10_000, seed=1)
    J_big, f_big = ev.jacobian(y_big, P_big)
    print('chunked: %d states -> J %s, dydt %s' %
          (len(y_big), J_big.shape, f_big.shape))


if __name__ == '__main__':
    main()
