"""Multi-device (virtual 8-device CPU mesh) sharding tests.

Validates that the sharded step compiles and executes over a
jax.sharding.Mesh with the batch axis partitioned on 1-8 devices, that
chunked BatchEvaluator results match the direct kernels whatever the
padding and chunk boundaries, and that the driver entry points work.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyjac_jax.ops.jacobian import eval_jacobian, jacobian_and_dydt
from pyjac_jax.parallel.mesh import (BatchEvaluator, batch_sharding,
                                     make_mesh, pad_batch, sharded_step)


def test_pad_batch():
    assert pad_batch(1020, 8) == 1024
    assert pad_batch(1024, 8) == 1024
    assert pad_batch(1, 8) == 8


def test_mesh_creation():
    mesh = make_mesh()
    assert mesh.devices.size == 8          # conftest forces 8 CPU devices
    mesh4 = make_mesh(4)
    assert mesh4.devices.size == 4


@pytest.mark.parametrize('n_devices', [1, 2, 4, 8])
def test_sharded_step_matches_direct(small_packed, small_states, n_devices):
    st = small_states
    B = 64                                  # divisible by every mesh size
    y = jnp.asarray(st['y'][:B])
    P = jnp.asarray(st['P'][:B])
    mesh = make_mesh(n_devices)
    step = sharded_step(small_packed, mesh, conp=True)
    J, f, norm = step(y, P)
    N = small_packed.n_species
    assert J.shape == (B, N, N) and f.shape == (B, N)
    # leading axis split over the mesh: one equal shard per device
    assert J.sharding.is_equivalent_to(batch_sharding(mesh), ndim=3)
    shards = J.addressable_shards
    assert len({s.device for s in shards}) == n_devices
    assert all(s.data.shape[0] == B // n_devices for s in shards)
    J_direct, f_direct = jacobian_and_dydt(small_packed, 0.0, P, y)
    scale = float(jnp.abs(J_direct).max())
    np.testing.assert_allclose(np.asarray(J) / scale,
                               np.asarray(J_direct) / scale, atol=1e-12)
    fscale = float(jnp.abs(f_direct).max())
    np.testing.assert_allclose(np.asarray(f) / fscale,
                               np.asarray(f_direct) / fscale, atol=1e-12)
    expect = float(jnp.abs(J_direct).max() + jnp.abs(f_direct).max())
    assert float(norm) == pytest.approx(expect, rel=1e-12)


@pytest.mark.parametrize('n,chunk,n_devices', [
    (100, 32, 8),       # not divisible by the device count
    (128, 32, 8),       # whole number of chunks, no padding
    (129, 64, 4),       # one state past a chunk boundary
    (5, 32, 8),         # fewer states than devices
    (64, 1000, 2),      # one chunk smaller than chunk_size
    (37, 16, 1),        # single device, ragged tail
])
def test_batch_evaluator_chunked(small_packed, small_states, n, chunk,
                                 n_devices):
    st = small_states
    y = st['y'][:n]
    P = st['P'][:n]
    N = small_packed.n_species
    ev = BatchEvaluator(small_packed, make_mesh(n_devices), chunk_size=chunk)
    assert ev.chunk_size % n_devices == 0
    J, f = ev.jacobian(y, P)
    assert J.shape == (n, N, N) and f.shape == (n, N)
    # the padded tail chunk has the same shape: one compile per call
    assert ev._jac._cache_size() == 1
    J_direct, f_direct = jacobian_and_dydt(small_packed, 0.0,
                                           jnp.asarray(P), jnp.asarray(y))
    scale = float(jnp.abs(J_direct).max())
    np.testing.assert_allclose(J / scale, np.asarray(J_direct) / scale,
                               atol=1e-12)
    fscale = float(jnp.abs(f_direct).max())
    np.testing.assert_allclose(f / fscale, np.asarray(f_direct) / fscale,
                               atol=1e-12)
    f2 = ev.dydt(y, P)
    assert f2.shape == (n, N)
    np.testing.assert_allclose(f2 / fscale, f / fscale, atol=1e-12)


def test_batch_evaluator_conv_scalar_param(small_packed, small_states):
    """CONV with one density for the whole batch (a broadcast scalar)."""
    y = small_states['y'][:20]
    rho = 1.7
    ev = BatchEvaluator(small_packed, make_mesh(4), conp=False,
                        chunk_size=8)
    J, f = ev.jacobian(y, rho)
    J_direct = np.asarray(eval_jacobian(small_packed, 0.0, rho,
                                        jnp.asarray(y), conp=False))
    scale = np.abs(J_direct).max()
    np.testing.assert_allclose(J / scale, J_direct / scale, atol=1e-12)


def test_default_chunk_fits_budget(small_packed):
    """The default chunk bounds the (chunk, R, N) f64 tensors to ~2 GB
    per device and stays a multiple of the device count."""
    ev = BatchEvaluator(small_packed, make_mesh(8))
    R, N = small_packed.n_reactions, small_packed.n_species
    per_device = ev.chunk_size // 8
    assert ev.chunk_size % 8 == 0
    assert per_device == min(int(2e9 / (R * N * 8)), 32768)


def test_graft_entry_dryrun():
    import sys
    sys.path.insert(0, str(__import__('pathlib').Path(
        __file__).resolve().parent.parent))
    from __graft_entry__ import dryrun_multichip, entry
    fn, args = entry()
    J, f = jax.jit(fn)(*args)
    assert J.shape == (64, 53, 53)
    dryrun_multichip(8)
