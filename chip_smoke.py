"""Smoke test of the f64 Jacobian and integrator path on the GPU.

Drives the system's main path through the entry points a user calls, at
the flagship mechanism's full width (53 species / 325 reactions, the
``__graft_entry__._flagship_packed`` plausible mechanism) over the
in-repo PaSR ensemble, and checks every result in f64:

1. flagship Jacobian + dy/dt, CONP and CONV, B = 131072: through
   ``BatchEvaluator.jacobian`` (host arrays in and out) and as one
   jitted ``jacobian_and_dydt`` over device-resident inputs;
2. correctness on the card: the reference-C goldens of the flagship and
   of the all-rate-forms 9/24 synthetic mechanism, every 512th batch
   state against the same code on the CPU and against forward-mode AD
   on the card, and a scan of the compiled program for f32 matrix
   products;
3. ``integrate`` (rodas3 and ros23) of 4096 PaSR states over a 1e-6 s
   substep, against the same call on the CPU in f64.

With ``--cards 4`` it runs only the multi-device path (``BatchEvaluator``
and ``sharded_step`` on a 4-GPU ``'batch'`` mesh) and the one-GPU
results it is compared with.

Every time is printed beside the card's name and power limit.  Any
failed gate exits non-zero before the last line, which is one JSON
object naming the device.  Without a GPU it exits non-zero and prints
no result.

Run: python chip_smoke.py [--cards 4]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

B_FLAGSHIP = 131072
CHECK_STRIDE = 512          # every 512th batch state is cross-checked
B_INTEGRATE = 4096
CPU_STRIDE = 16             # integration states re-run on the CPU
T_SUBSTEP = 1e-6
RTOL, ATOL = 1e-6, 1e-10

CARD = '?'                  # nvidia-smi name, power limit


class GateFailure(Exception):
    pass


class Gates:
    """Prints each f64 gate as it is checked and remembers failures."""

    def __init__(self):
        self.failed = []

    def check(self, name, value, limit):
        ok = bool(value <= limit)           # NaN fails
        print('  %-44s %.3e  (gate <= %.0e) %s'
              % (name, value, limit, 'ok' if ok else 'FAIL'))
        if not ok:
            self.failed.append(name)

    def close(self, phase):
        if self.failed:
            raise GateFailure('%s: failed gates %s' % (phase, self.failed))


def floored_max_rel(a, b, floor):
    """Max relative error, entries below ``floor * max|b|`` of their
    state compared against that floor (the golden tests' metric)."""
    a = np.asarray(a).reshape(len(a), -1)
    b = np.asarray(b).reshape(len(b), -1)
    denom = np.maximum(np.abs(b),
                       np.abs(b).max(-1, keepdims=True) * floor + 1e-300)
    return float((np.abs(a - b) / denom).max())


def norm_rel(a, b):
    """Max over states of max|a - b| / max|b|."""
    a = np.asarray(a).reshape(len(a), -1)
    b = np.asarray(b).reshape(len(b), -1)
    return float((np.abs(a - b).max(-1) / np.abs(b).max(-1)).max())


def timed_call(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 1: flagship Jacobian + dy/dt
# ---------------------------------------------------------------------------

def phase_flagship(packed, B=B_FLAGSHIP, device=None, repeats=3):
    """BatchEvaluator (host in/out) and device-resident jitted
    ``jacobian_and_dydt``, CONP and CONV; returns the sampled states and
    outputs the correctness phase checks."""
    import jax

    from bench import bench_states, density, time_jacobian
    from pyjac_jax.parallel.mesh import BatchEvaluator, make_mesh
    from pyjac_jax.profiling import speed_of_light

    print('== phase 1: flagship Jacobian + dy/dt, B=%d' % B)
    y, P = bench_states(B)
    samples = {}
    for conp in (True, False):
        mode = 'CONP' if conp else 'CONV'
        param = P if conp else density(packed, y, P)
        mesh = make_mesh(1) if device is None else \
            jax.sharding.Mesh(np.asarray([device]), ('batch',))
        ev = BatchEvaluator(packed, mesh, conp=conp)
        (J_h, f_h), first_s = timed_call(ev.jacobian, y, param)
        (J_h, f_h), host_s = timed_call(ev.jacobian, y, param)
        print('%s BatchEvaluator.jacobian host->host: chunk %d states, '
              'first call (incl. compile) %.3f s, steady %.3f s = %.1f '
              'evals/s [card: %s]'
              % (mode, min(ev.chunk_size, B), first_s, host_s,
                 B / host_s, CARD))
        compiled, (J, f), compile_s, pass_s = time_jacobian(
            packed, y, param, conp=conp, repeats=repeats, device=device)
        best = min(pass_s)
        print('%s jitted jacobian_and_dydt device-resident: compile %.3f s '
              '(set-up), passes %s s, best %.6f s = %.1f evals/s '
              '[card: %s]' % (mode, compile_s,
                              ['%.6f' % t for t in pass_s], best,
                              B / best, CARD))
        print('%s memory_analysis: %s' % (mode, compiled.memory_analysis()))
        if device is None:
            sol = speed_of_light(packed, jax.devices()[0].device_kind)
            print('%s roofline bound of profiling.cost_estimate: memory %.1f'
                  ' evals/s, compute %.1f evals/s; measured %.1f%% of the '
                  'lower' % (mode, sol['memory_bound_evals_per_sec'],
                             sol['compute_bound_evals_per_sec'],
                             100.0 * (B / best) /
                             min(sol['memory_bound_evals_per_sec'],
                                 sol['compute_bound_evals_per_sec'])))
        if not (np.isfinite(float(J.sum())) and
                np.isfinite(float(f.sum()))):
            raise GateFailure('%s: non-finite Jacobian output' % mode)
        sel = np.arange(0, B, CHECK_STRIDE)
        J_s, f_s = np.asarray(J[sel]), np.asarray(f[sel])
        gates = Gates()
        gates.check('%s BatchEvaluator vs device-resident J' % mode,
                    norm_rel(J_h[sel], J_s), 1e-12)
        gates.check('%s BatchEvaluator vs device-resident f' % mode,
                    norm_rel(f_h[sel], f_s), 1e-12)
        gates.close('flagship %s' % mode)
        samples[mode] = (y[sel], param[sel], J_s, f_s, compiled)
        del J, f, J_h, f_h
    return samples


# ---------------------------------------------------------------------------
# phase 2: correctness on the card
# ---------------------------------------------------------------------------

def _evaluate_all(packed, T, P, y, device):
    """Every golden-compared intermediate, one jitted call on
    ``device``."""
    import jax

    from pyjac_jax.ops import rates, thermo
    from pyjac_jax.ops.dydt import dydt_conp
    from pyjac_jax.ops.jacobian import eval_jacobian

    def fn(T, P, y):
        _, _, _, conc = thermo.eval_conc(packed, T, P, y[:, 1:])
        fwd, rev = rates.eval_rxn_rates(packed, T, P, conc)
        pm = rates.get_rxn_pres_mod(packed, T, P, conc)
        return {
            'conc': conc, 'fwd': fwd,
            'rev': rates.compact_rev(packed, rev),
            'pres_mod': rates.compact_pres_mod(packed, pm),
            'spec_rates': rates.eval_spec_rates(packed, fwd, rev, pm),
            'dydt': dydt_conp(packed, 0.0, P, y),
            'jac': eval_jacobian(packed, 0.0, P, y),
        }

    args = [jax.device_put(np.asarray(a), device) for a in (T, P, y)]
    out = jax.jit(fn)(*args)
    out = {k: np.asarray(v) for k, v in out.items()}
    n = len(T)
    # reference layout: jac[i + NSP*j] = df_i/dy_j (column-major)
    out['jac'] = out['jac'].transpose(0, 2, 1).reshape(n, -1)
    return out


def golden_flagship(packed, device, gates):
    """tests/test_golden_parity.py TestFlagshipGolden gates, on the
    card."""
    from bench import STATES
    g = np.load(os.path.join(os.path.dirname(STATES),
                             'golden_flagship_refc.npz'))
    out = _evaluate_all(packed, g['T'], g['P'], g['y'], device)
    for key in ('conc', 'fwd', 'rev', 'pres_mod'):
        gates.check('flagship refC %s floored max-rel' % key,
                    floored_max_rel(out[key], g['ref_' + key], 1e-12),
                    1e-12)
    gates.check('flagship refC J floored(1e-10) max-rel',
                floored_max_rel(out['jac'], g['ref_jac'], 1e-10), 1e-10)
    # near-equilibrium PaSR states: net rates cancel, so norm-relative
    for key in ('spec_rates', 'dydt'):
        gates.check('flagship refC %s norm-rel' % key,
                    norm_rel(out[key], g['ref_' + key]), 1e-7)


def golden_synth(device, gates):
    """The all-rate-forms 9/24 synthetic mechanism (PLOG, Chebyshev,
    SRI, chemically-activated, fractional orders) against its
    reference-C golden, gates of TestAllFeaturesGolden."""
    import tempfile

    from bench import STATES
    from pyjac_jax.core.mech import Mechanism
    from pyjac_jax.core.pack import pack
    from pyjac_jax.testers.synthetic import synthetic_mechanism

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'synth.inp')
        with open(path, 'w') as fh:
            fh.write(synthetic_mechanism(n_species=9, n_reactions=24,
                                         seed=7))
        packed = pack(Mechanism.from_files(path))
    g = np.load(os.path.join(os.path.dirname(STATES),
                             'golden_synth_refc.npz'))
    out = _evaluate_all(packed, g['T'], g['P'], g['y'], device)
    # conc at 1e-12, not the CPU test's 1e-13: the closure species'
    # Y_N = 1 - sum(Y) cancels, and the card sums in another order, so
    # its concentration moves by ~1 ulp of 1 relative to Y_N (2.1e-13
    # measured on the H100)
    for key, ref, tol in (('conc', 'ref_conc', 1e-12),
                          ('fwd', 'ref_fwd', 1e-8),
                          ('rev', 'ref_rev', 1e-12),
                          ('pres_mod', 'ref_pm', 1e-13),
                          ('spec_rates', 'ref_sp', 1e-10),
                          ('dydt', 'ref_dydt', 1e-10),
                          ('jac', 'ref_jac', 1e-8)):
        gates.check('synth 9/24 refC %s floored(1e-9) max-rel' % key,
                    floored_max_rel(out[key], g[ref], 1e-9), tol)


def f32_dots(compiled):
    """Matrix products of the compiled program (XLA dots, convolutions
    and library GEMM calls) that touch f32 data."""
    import re
    hlo = compiled.as_text()
    return [line.strip() for line in hlo.splitlines()
            if re.search(r'\b(dot|convolution)\(|gemm', line)
            and 'f32[' in line]


def phase_correctness(packed, samples, device=None):
    import jax

    from pyjac_jax.ops.jacobian import jacobian_and_dydt, jacobian_fwd

    print('== phase 2: correctness on the card (f64 gates)')
    cpu = jax.devices('cpu')[0]
    gates = Gates()
    golden_flagship(packed, device, gates)
    golden_synth(device, gates)
    for mode, (y, param, J, f, compiled) in samples.items():
        conp = mode == 'CONP'
        fn = jax.jit(lambda p, yy: jacobian_and_dydt(packed, 0.0, p, yy,
                                                     conp=conp))
        J_c, f_c = fn(jax.device_put(param, cpu), jax.device_put(y, cpu))
        gates.check('%s %d states J vs CPU floored(1e-10) max-rel'
                    % (mode, len(y)), floored_max_rel(J, J_c, 1e-10), 1e-8)
        gates.check('%s %d states f vs CPU norm-rel' % (mode, len(y)),
                    norm_rel(f, f_c), 1e-8)
        ad = jax.jit(lambda p, yy: jacobian_fwd(packed, 0.0, p, yy,
                                                conp=conp))
        J_ad = ad(jax.device_put(param, device), jax.device_put(y, device))
        gates.check('%s J vs jacobian_fwd (card) floored(1e-10)' % mode,
                    floored_max_rel(J, J_ad, 1e-10), 1e-8)
        found = f32_dots(compiled)
        print('  %s compiled program: %d f32 matrix products%s'
              % (mode, len(found), ''.join('\n    ' + d for d in found)))
        if found:
            gates.failed.append('%s f32 matmul' % mode)
    print('  all arrays f64; jax_default_matmul_precision = %s'
          % jax.config.jax_default_matmul_precision)
    gates.close('correctness')


# ---------------------------------------------------------------------------
# phase 3: integration
# ---------------------------------------------------------------------------

def phase_integrate(packed, B=B_INTEGRATE, device=None):
    import jax

    from bench import bench_states
    from pyjac_jax.integrate import integrate

    print('== phase 3: integrate %d flagship PaSR states over %.0e s '
          '(rtol %.0e, atol %.0e)' % (B, T_SUBSTEP, RTOL, ATOL))
    cpu = jax.devices('cpu')[0]
    y, P = bench_states(B)
    sel = np.arange(0, B, CPU_STRIDE)
    gates = Gates()
    for method in ('rodas3', 'ros23'):
        fn = jax.jit(lambda yy, pp: integrate(
            packed, yy, pp, T_SUBSTEP, rtol=RTOL, atol=ATOL, method=method))
        yd, pd = jax.device_put(y, device), jax.device_put(P, device)
        t0 = time.perf_counter()
        compiled = fn.lower(yd, pd).compile()
        compile_s = time.perf_counter() - t0
        res, first_s = timed_call(compiled, yd, pd)
        res, run_s = timed_call(compiled, yd, pd)
        st = np.asarray(res.status)
        steps, rej = np.asarray(res.steps), np.asarray(res.rejected)
        print('%s: compile %.3f s (set-up), run %.6f s (first %.6f s) '
              '[card: %s]; accepted %d (max %d/state), rejected %d, '
              'status counts %s'
              % (method, compile_s, run_s, first_s, CARD, steps.sum(),
                 steps.max(), rej.sum(),
                 dict(zip(*[a.tolist() for a in np.unique(
                     st, return_counts=True)]))))
        ref, cpu_s = timed_call(fn, jax.device_put(y[sel], cpu),
                                jax.device_put(P[sel], cpu))
        print('  CPU f64 reference on %d states (every %dth): %.3f s '
              'incl. compile' % (len(sel), CPU_STRIDE, cpu_s))
        yg, yc = np.asarray(res.y)[sel], np.asarray(ref.y)
        scaled = np.abs(yg - yc) / (ATOL + RTOL * np.abs(yc))
        gates.check('%s all states succeed (failures)' % method,
                    float((st != 0).sum() + (np.asarray(ref.status) != 0)
                          .sum()), 0)
        gates.check('%s |y_gpu - y_cpu| / (atol + rtol|y|)' % method,
                    float(scaled.max()), 1.0)
    gates.close('integrate')


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_four_cards(packed, n_cards=4, B=B_FLAGSHIP, repeats=3):
    """``BatchEvaluator`` and ``sharded_step`` on an ``n_cards`` mesh
    against the one-device results."""
    import jax

    from bench import bench_states
    from pyjac_jax.parallel.mesh import (BatchEvaluator, make_mesh,
                                         sharded_step)

    print('== %d-device mesh: BatchEvaluator + sharded_step, CONP, B=%d'
          % (n_cards, B))
    y, P = bench_states(B)
    gates = Gates()
    mesh1, meshn = make_mesh(1), make_mesh(n_cards)
    res = {}
    for name, mesh in (('1-device', mesh1), ('%d-device' % n_cards, meshn)):
        ev = BatchEvaluator(packed, mesh)
        _, first_s = timed_call(ev.jacobian, y, P)
        (J_h, f_h), host_s = timed_call(ev.jacobian, y, P)
        print('%s BatchEvaluator.jacobian host->host: chunk %d, first '
              '(incl. compile) %.3f s, steady %.3f s = %.1f evals/s '
              '[card: %s]' % (name, min(ev.chunk_size, B), first_s, host_s,
                              B / host_s, CARD))
        step = sharded_step(packed, mesh)
        yd = jax.device_put(y, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec('batch')))
        pd = jax.device_put(P, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec()))
        _, first_s = timed_call(step, yd, pd)
        times = []
        for _ in range(repeats):
            (J, f, norm), dt = timed_call(step, yd, pd)
            times.append(dt)
        print('%s sharded_step device-resident: first (incl. compile) '
              '%.3f s, passes %s s, best %.6f s = %.1f evals/s [card: %s]'
              % (name, first_s, ['%.6f' % t for t in times], min(times),
                 B / min(times), CARD))
        shards = J.addressable_shards
        rows = sorted((s.device.id, s.data.shape[0]) for s in shards)
        print('  J shards (device id, states): %s' % rows)
        res[name] = (J_h[::CHECK_STRIDE], f_h[::CHECK_STRIDE],
                     np.asarray(J[::CHECK_STRIDE]),
                     np.asarray(f[::CHECK_STRIDE]), float(norm), rows)
        del J, f, J_h, f_h
    J1h, f1h, J1, f1, n1, _ = res['1-device']
    Jnh, fnh, Jn, fn, nn, rows = res['%d-device' % n_cards]
    gates.check('shards on distinct devices (missing)',
                float(n_cards - len({d for d, _ in rows})), 0)
    gates.check('states per shard off B/%d' % n_cards,
                float(max(abs(r - B // n_cards) for _, r in rows)), 0)
    gates.check('BatchEvaluator J %d vs 1 norm-rel' % n_cards,
                norm_rel(Jnh, J1h), 1e-12)
    gates.check('BatchEvaluator f %d vs 1 norm-rel' % n_cards,
                norm_rel(fnh, f1h), 1e-12)
    gates.check('sharded_step J %d vs 1 norm-rel' % n_cards,
                norm_rel(Jn, J1), 1e-12)
    gates.check('sharded_step f %d vs 1 norm-rel' % n_cards,
                norm_rel(fn, f1), 1e-12)
    gates.check('sharded_step norm %d vs 1 rel' % n_cards,
                abs(nn - n1) / abs(n1), 1e-12)
    gates.close('%d-device mesh' % n_cards)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--cards', type=int, default=1, choices=(1, 4),
                        help='4: run only the 4-GPU mesh path and the '
                             'one-GPU results it is compared with')
    args = parser.parse_args(argv)

    # one process drives the card(s): let it hold 90% of device memory
    os.environ.setdefault('XLA_PYTHON_CLIENT_MEM_FRACTION', '0.90')
    import jax
    jax.config.update('jax_enable_x64', True)
    devs = jax.devices()
    if devs[0].platform != 'gpu' or len(devs) < args.cards:
        print('chip_smoke: needs %d GPU(s); JAX found %d %r device(s)'
              % (args.cards, len(devs), devs[0].platform), file=sys.stderr)
        return 2

    from bench import card_name_and_power_limit
    from pyjac_jax.compile_cache import enable_compile_cache
    from __graft_entry__ import _flagship_packed

    global CARD
    cards = card_name_and_power_limit()
    print(cards)
    CARD = cards.splitlines()[0]
    print('device: %s, kind %r, count %d; compile cache %s'
          % (devs[0].platform, devs[0].device_kind, len(devs),
             enable_compile_cache()))
    _, packed = _flagship_packed()
    t0 = time.perf_counter()
    try:
        if args.cards == 4:
            phase_four_cards(packed, n_cards=4)
        else:
            samples = phase_flagship(packed)
            phase_correctness(packed, samples)
            phase_integrate(packed)
    except GateFailure as e:
        print('chip_smoke FAILED: %s' % e, file=sys.stderr)
        return 1
    print('all phases passed in %.1f s [card: %s]'
          % (time.perf_counter() - t0, CARD))
    print(json.dumps({'ok': True, 'device': {
        'platform': devs[0].platform, 'kind': devs[0].device_kind,
        'count': len(devs)}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
