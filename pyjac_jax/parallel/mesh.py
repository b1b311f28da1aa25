"""Multi-device batch parallelism over a device mesh.

The reference's only distribution axis is the thermochemical-state batch
(OpenMP threads / one CUDA thread per state,
reference: pyjac/performance_tester/tester.c.in:24-29,
pyjac/pywrap/pyjacob.cu:14-35).  Here the same axis becomes a
``jax.sharding.Mesh`` with a single ``'batch'`` axis: states are sharded
over the devices, the kernels are embarrassingly parallel (no
collectives in the hot path), and only harness-level reductions (error
norms) cross devices.

Per-device memory budgeting is handled by :class:`BatchEvaluator`'s
chunking, the analog of the reference's GPU capacity loop
(reference: pyjac/pywrap/pyjacob.cu:99-107, tester.cu.in:110-138).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.dydt import dydt as dydt_dispatch
from ..ops.jacobian import eval_jacobian


def make_mesh(n_devices: Optional[int] = None, axis: str = 'batch') -> Mesh:
    """A 1-D device mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def batch_sharding(mesh: Mesh, axis: str = 'batch') -> NamedSharding:
    """Shard the leading (state) dimension across the mesh."""
    return NamedSharding(mesh, P(axis))


def pad_batch(n: int, divisor: int) -> int:
    """Round a batch size up to a multiple of ``divisor`` (the analog of
    the reference's padding to CUDA block multiples, pyjacob.cu:104-121).
    """
    return ((n + divisor - 1) // divisor) * divisor


class BatchEvaluator:
    """Sharded, chunked evaluation of dydt / Jacobian over huge state
    batches.

    States are split into equal, device-count-aligned chunks that fit
    per-device memory, each chunk is dispatched with the batch axis
    sharded over the mesh, and results are returned to host memory
    (suitable for parity harnesses; production integrators keep
    everything device-resident).  The last chunk is padded by repeating
    the final state, so every chunk has one shape and the step compiles
    once per batch size.
    """

    def __init__(self, packed, mesh: Optional[Mesh] = None,
                 conp: bool = True, chunk_size: Optional[int] = None):
        self.packed = packed
        self.mesh = mesh if mesh is not None else make_mesh()
        self.conp = conp
        self.n_devices = self.mesh.devices.size
        if chunk_size is None:
            chunk_size = self._default_chunk()
        self.chunk_size = pad_batch(chunk_size, self.n_devices)
        self._sharding = batch_sharding(self.mesh)

        sh = self._sharding

        @partial(jax.jit,
                 in_shardings=(sh, NamedSharding(self.mesh, P())),
                 out_shardings=sh)
        def _dydt(y, param):
            return dydt_dispatch(packed, 0.0, param, y, conp=conp)

        @partial(jax.jit,
                 in_shardings=(sh, NamedSharding(self.mesh, P())),
                 out_shardings=(sh, sh))
        def _jac(y, param):
            return eval_jacobian(packed, 0.0, param, y, conp=conp,
                                 return_dydt=True)

        self._dydt = _dydt
        self._jac = _jac

    def _default_chunk(self) -> int:
        """Size chunks so the dominant (chunk, R, N) f64 work tensors use
        at most ~2 GB per device (several live at once under fusion)."""
        per_state = self.packed.n_reactions * self.packed.n_species * 8
        per_device = max(1, int(2e9 / max(per_state, 1)))
        return min(per_device, 32768) * max(self.n_devices, 1)

    def _padded(self, y: np.ndarray, param):
        """(y, param, chunk) with the batch padded to a whole number of
        equal chunks by repeating the last state."""
        n = y.shape[0]
        param = np.broadcast_to(np.asarray(param), (n,))
        chunk = min(self.chunk_size, pad_batch(n, self.n_devices))
        extra = pad_batch(n, chunk) - n
        if extra:
            y = np.concatenate([y, np.repeat(y[-1:], extra, axis=0)])
            param = np.concatenate([param, np.repeat(param[-1:], extra)])
        return y, param, chunk

    def dydt(self, y, param):
        """dy/dt over an arbitrarily large host batch."""
        y = np.asarray(y)
        n = y.shape[0]
        out = np.empty_like(y)
        ypad, ppad, chunk = self._padded(y, param)
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            res = self._dydt(jnp.asarray(ypad[s:s + chunk]),
                             jnp.asarray(ppad[s:s + chunk]))
            out[s:e] = np.asarray(res)[:e - s]
        return out

    def jacobian(self, y, param):
        """(J, dy/dt) over an arbitrarily large host batch."""
        y = np.asarray(y)
        n, N = y.shape
        J_out = np.empty((n, N, N), dtype=y.dtype)
        f_out = np.empty_like(y)
        ypad, ppad, chunk = self._padded(y, param)
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            J, f = self._jac(jnp.asarray(ypad[s:s + chunk]),
                             jnp.asarray(ppad[s:s + chunk]))
            J_out[s:e] = np.asarray(J)[:e - s]
            f_out[s:e] = np.asarray(f)[:e - s]
        return J_out, f_out


def sharded_step(packed, mesh: Mesh, conp: bool = True):
    """A jitted 'full step' over the mesh: sharded Jacobian + dydt plus a
    cross-device max-norm reduction (the collective the parity/bench
    harness needs).  Used by the multi-device dry run."""
    sh = batch_sharding(mesh)
    rep = NamedSharding(mesh, P())

    @partial(jax.jit, in_shardings=(sh, rep),
             out_shardings=(sh, sh, rep))
    def step(y, param):
        J, f = eval_jacobian(packed, 0.0, param, y, conp=conp,
                             return_dydt=True)
        # the only collective: XLA inserts the cross-device all-reduce
        norm = jnp.max(jnp.abs(J)) + jnp.max(jnp.abs(f))
        return J, f, norm

    return step


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialise multi-host JAX before building meshes.

    The reference is strictly single-node (SURVEY §2.3); this is the
    multi-host growth path: call once per host, then ``make_mesh()``
    sees all global devices and the batch axis shards across hosts
    (state batches stay host-local via ``jax.make_array_from_*``).
    No-op when JAX is already initialised or running single-process.
    """
    if coordinator_address is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
