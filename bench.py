"""Flagship benchmark: fused analytical Jacobian + dy/dt on one GPU.

Mirrors the reference's performance tester metric (wall-clock for N
eval_jacob evaluations, reference: pyjac/performance_tester/tester.c.in:
23-31) on the flagship GRI-3.0-sized mechanism (53 species / 325
reactions, ``__graft_entry__._flagship_packed``) in f64 through the XLA
path (``ops.jacobian.jacobian_and_dydt``), CONP, B = 131072
device-resident states tiled from the in-repo PaSR ensemble
(``tests/data/flagship_states.npz``).

Compilation is reported as set-up; each timed pass ends in
``jax.block_until_ready`` on the full (J, f) output and the best of
``REPEATS`` passes is kept.  Prints the card, the device, the times and
one JSON line last.  Without a GPU it exits non-zero.

Run: python bench.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

B = 131072
REPEATS = 5
STATES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'tests', 'data', 'flagship_states.npz')


def require_gpu():
    """The first JAX device, which must be a GPU; otherwise exit."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise SystemExit('no GPU found: JAX platform is %r; this program '
                         'measures the GPU and has no CPU fallback'
                         % dev.platform)
    return dev


def card_name_and_power_limit():
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def bench_states(n):
    """The flagship PaSR ensemble tiled to ``n`` states: (y, P), f64."""
    d = np.load(STATES)
    reps = -(-n // len(d['y']))
    y = np.tile(d['y'], (reps, 1))[:n]
    P = np.tile(d['P'], reps)[:n]
    return np.ascontiguousarray(y, np.float64), P.astype(np.float64)


def density(packed, y, P):
    """Mass density of CONP states (y, P): the CONV parameter."""
    from pyjac_jax.utils import full_mass_fractions, get_density
    return get_density(packed, y[:, 0], P, full_mass_fractions(y))


def time_jacobian(packed, y, param, conp=True, repeats=REPEATS,
                  device=None):
    """Compile and time one jitted ``jacobian_and_dydt`` over
    device-resident inputs.

    Returns ``(compiled, (J, f), compile_s, pass_s)``: the compiled
    executable, the outputs of the last pass, the lower+compile time
    and the wall time of each timed pass.
    """
    import jax

    from pyjac_jax.ops.jacobian import jacobian_and_dydt

    yd = jax.device_put(y, device)
    pd = jax.device_put(param, device)
    jax.block_until_ready((yd, pd))
    t0 = time.perf_counter()
    compiled = jax.jit(
        lambda p, yy: jacobian_and_dydt(packed, 0.0, p, yy, conp=conp)
    ).lower(pd, yd).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(pd, yd))       # warm-up pass
    pass_s = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(pd, yd))
        pass_s.append(time.perf_counter() - t0)
    return compiled, out, compile_s, pass_s


def main():
    # one process drives the card: let it hold 90% of device memory
    os.environ.setdefault('XLA_PYTHON_CLIENT_MEM_FRACTION', '0.90')
    import jax
    jax.config.update('jax_enable_x64', True)
    dev = require_gpu()
    from pyjac_jax.compile_cache import enable_compile_cache
    enable_compile_cache()
    from __graft_entry__ import _flagship_packed

    card = card_name_and_power_limit()
    print('card: %s' % card)
    print('device: %s (%s) x %d'
          % (dev.platform, dev.device_kind, len(jax.devices())))
    _, packed = _flagship_packed()
    y, P = bench_states(B)
    _, (J, f), compile_s, pass_s = time_jacobian(packed, y, P)
    if not (np.isfinite(float(J.sum())) and np.isfinite(float(f.sum()))):
        raise SystemExit('non-finite benchmark output')
    best = min(pass_s)
    print('flagship CONP B=%d: compile %.3f s (set-up); passes %s s; '
          'best %.6f s = %.1f evals/s [card: %s]'
          % (B, compile_s, ['%.6f' % t for t in pass_s], best, B / best,
             card))
    print(json.dumps({
        'metric': 'flagship_jacobian_dydt_f64_conp',
        'value': B / best,
        'unit': 'evals/s',
        'batch': B,
        'best_pass_s': best,
        'compile_s': compile_s,
        'card': card,
        'device': {'platform': dev.platform, 'kind': dev.device_kind,
                   'count': len(jax.devices())},
    }))


if __name__ == '__main__':
    sys.exit(main())
