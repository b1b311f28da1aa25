"""Profiling and cost accounting.

The reference's observability is a wall-clock timer and CSV lines
(reference: pyjac/performance_tester/timer.h:24-53, tester.c.in:31).
This package exposes:

* :func:`trace` — a context manager around the JAX profiler producing
  TensorBoard-compatible traces of the compiled kernels,
* :func:`cost_estimate` — closed-form FLOP / byte accounting per kernel
  per state, derived from the packed mechanism (the basis for
  roofline/speed-of-light analysis of the hot kernels),
* :data:`DEVICE_PEAKS` / :func:`speed_of_light` — published peak rates
  keyed by ``jax.Device.device_kind``, and the roofline bound they give,
* :func:`timed` — wall-clock timing of calls that each end in
  ``jax.block_until_ready`` on the full result.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Dict


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block of device work into ``log_dir``."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class CostEstimate:
    flops_per_state: float
    transcendentals_per_state: float
    bytes_per_state: float

    def arithmetic_intensity(self) -> float:
        return self.flops_per_state / max(self.bytes_per_state, 1.0)


def cost_estimate(packed, kernel: str = 'jacobian',
                  dtype_bytes: int = 8) -> CostEstimate:
    """Analytic per-state cost of a kernel for roofline analysis."""
    N = packed.n_species
    R = packed.n_reactions
    Sf = packed.reac_sp.shape[1]
    Sp = packed.prod_sp.shape[1]

    # rates: kf/Kc exponentials, slot products, nu^T q matmul
    trans = 3.0 * R                      # exp(kf), exp(Kc), assorted logs
    flops_rates = R * (10 + 3 * (Sf + Sp)) + 2.0 * R * N   # + spec matmul
    bytes_rates = (N + 4 * R) * dtype_bytes

    if kernel == 'rates':
        return CostEstimate(flops_rates, trans, bytes_rates)
    if kernel == 'dydt':
        return CostEstimate(flops_rates + 8.0 * N, trans + 2 * N,
                            bytes_rates + 2 * N * dtype_bytes)
    if kernel == 'jacobian':
        # dominant: dense nu^T @ P1 matmul (N x R)(R x N-1) plus the
        # O(R N) P1/D assembly and O(R) scalar derivative terms
        flops = (flops_rates + 2.0 * R * N * (N - 1) + 10.0 * R * N +
                 40.0 * R + 8.0 * N * N)
        bytes_ = (3.0 * R * N + N * N + 6 * R) * dtype_bytes
        return CostEstimate(flops, trans + 4.0 * R, bytes_)
    raise ValueError('unknown kernel ' + kernel)


# Published peak rates per device kind, as ``jax.Device.device_kind``
# reports it. Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part,
# dense rates without sparsity, at the card's full 700 W power limit.
DEVICE_PEAKS: Dict[str, Dict[str, float]] = {
    'NVIDIA H100 80GB HBM3': {
        'f64_flops': 34e12,            # FP64, vector units
        'f64_tensor_flops': 67e12,     # FP64 tensor cores
        'f32_flops': 67e12,            # FP32, vector units
        'mem_bytes_per_s': 3.35e12,    # HBM3
    },
}


def device_peaks(device_kind: str) -> Dict[str, float]:
    """Published peaks of ``device_kind``; a device missing from
    :data:`DEVICE_PEAKS` is an error, never a default."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise ValueError('no published peak rates for device kind %r; '
                         'add them to DEVICE_PEAKS with their source'
                         % (device_kind,)) from None


def speed_of_light(packed, device_kind: str, kernel: str = 'jacobian',
                   dtype_bytes: int = 8) -> Dict[str, float]:
    """Upper-bound throughput (evals/s) from the roofline model, against
    the published peaks of ``device_kind``: the FP64 tensor-core rate
    for 8-byte data, the FP32 vector rate for 4-byte data."""
    peaks = device_peaks(device_kind)
    peak_flops = (peaks['f64_tensor_flops'] if dtype_bytes == 8
                  else peaks['f32_flops'])
    c = cost_estimate(packed, kernel, dtype_bytes)
    return {
        'compute_bound_evals_per_sec': peak_flops / c.flops_per_state,
        'memory_bound_evals_per_sec':
            peaks['mem_bytes_per_s'] / c.bytes_per_state,
        'arithmetic_intensity': c.arithmetic_intensity(),
    }


def timed(fn: Callable, *args, iters: int = 5, warmup: int = 1):
    """(result, seconds_per_call); every call, warm-up included, ends in
    ``jax.block_until_ready`` on its full result."""
    import jax

    result = None
    for _ in range(max(warmup, 1)):
        result = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        result = jax.block_until_ready(fn(*args))
    return result, (time.perf_counter() - t0) / iters
