"""Generate the flagship benchmark state ensemble.

The reference benches on PaSR-sampled physics (reference:
pyjac/performance_tester/performance_tester.py:316-338 packs PaSR .npy
data into data.bin).  The flagship benchmark mechanism is synthetic
(real GRI-3.0 is unobtainable offline), and its random NASA-7 thermo
admits no meaningful time integration: mixed compositions sit ~1e21/s
off any kinetic manifold (measured dT/dt ~ -1.6e21 K/s), so a PaSR
run — whose chemistry substep integrates particles in time — diverges
for any horizon.  This generator reproduces the *structural properties*
PaSR sampling gives real mechanisms, using the framework's own
chemistry:

* **stream sparsity** — each state zeroes a random subset of species
  (PaSR particles are convex combinations of a few inlet/pilot
  streams; most species are exactly absent), exercising the kernels'
  exact-zero paths;
* **manifold proximity** — damped Newton steps toward quasi-steady
  state (solve J dy = f, the implicit-integrator inner iteration) damp
  the fast modes, leaving states where forward and reverse rates
  nearly cancel — the near-equilibrium cancellation structure that
  makes the thresholded parity metric hard, and the regime implicit
  integrators actually evaluate Jacobians in;
* **physical T/P bands** — T in [1500, 2500] K at 10 atm, clipped
  during relaxation.

Output: tests/data/flagship_states.npz with (y, P) in internal packed
order, f64; bench.py tiles these to its batch size (the reference
likewise loops its fixed PaSR dataset).

Run: python tools/make_bench_states.py [--n 4096] [--out PATH]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=4096)
    ap.add_argument('--seed', type=int, default=7)
    ap.add_argument('--newton', type=int, default=3)
    ap.add_argument('--pasr', action='store_true',
                    help='sample states from an actual PaSR run '
                         '(requires the time-integrable plausible '
                         'flagship; the BASELINE metric is "1M PaSR '
                         'states")')
    ap.add_argument('--out', default=os.path.join(
        os.path.dirname(__file__), '..', 'tests', 'data',
        'flagship_states.npz'))
    args = ap.parse_args(argv)
    if args.pasr:
        return main_pasr(args)

    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import _flagship_packed
    from pyjac_jax.integrate import gauss_solve
    from pyjac_jax.ops.dydt import dydt
    from pyjac_jax.ops.jacobian import eval_jacobian
    from pyjac_jax.testers.synthetic import random_states

    mech, packed = _flagship_packed()
    N = packed.n_species
    rng = np.random.default_rng(args.seed)

    y, _, P = random_states(mech, args.n, seed=args.seed,
                            T_range=(1500.0, 2500.0))
    y = y.astype(np.float64)
    P = P.astype(np.float64)

    # stream sparsity: zero a random subset of the reduced species
    # (between 20% and 70% per state), keeping at least 5 present
    Y = y[:, 1:]
    for i in range(args.n):
        k = rng.integers(int(0.2 * (N - 1)), int(0.7 * (N - 1)))
        drop = rng.choice(N - 1, size=k, replace=False)
        Y[i, drop] = 0.0
    # renormalise so the eliminated species keeps a physical share
    ssum = Y.sum(axis=1, keepdims=True)
    Y *= np.where(ssum > 0.9, 0.9 / ssum, 1.0)
    y[:, 1:] = Y

    f0 = np.abs(np.asarray(dydt(packed, 0.0, jnp.asarray(P),
                                jnp.asarray(y)))).max()

    # damped Newton toward quasi-steady state: the implicit-integrator
    # inner iteration, batched (fast modes damp; positivity clipped)
    for it in range(args.newton):
        J = eval_jacobian(packed, 0.0, jnp.asarray(P), jnp.asarray(y))
        f = dydt(packed, 0.0, jnp.asarray(P), jnp.asarray(y))
        step = np.asarray(gauss_solve(J, f))
        # per-state damping: cap the temperature move at 150 K and the
        # mass-fraction move at 0.05
        alpha = np.minimum(
            1.0, np.minimum(
                150.0 / (np.abs(step[:, 0]) + 1e-300),
                0.05 / (np.abs(step[:, 1:]).max(axis=1) + 1e-300)))
        y = y - alpha[:, None] * step
        y[:, 0] = np.clip(y[:, 0], 1200.0, 2800.0)
        y[:, 1:] = np.clip(y[:, 1:], 0.0, 1.0)
        s = y[:, 1:].sum(axis=1, keepdims=True)
        y[:, 1:] *= np.where(s > 1.0, 1.0 / s, 1.0)
        fi = np.abs(np.asarray(dydt(packed, 0.0, jnp.asarray(P),
                                    jnp.asarray(y)))).max()
        print('newton %d: max|dydt| %.3e (start %.3e)' % (it, fi, f0))

    f = np.asarray(dydt(packed, 0.0, jnp.asarray(P), jnp.asarray(y)))
    J = np.asarray(eval_jacobian(packed, 0.0, jnp.asarray(P),
                                 jnp.asarray(y)))
    assert np.isfinite(f).all() and np.isfinite(J).all()
    nz = int((y[:, 1:] == 0.0).sum())
    print('states: %d, exact-zero mass fractions: %d (%.0f%%), '
          'T %.0f..%.0f K' % (args.n, nz,
                              100.0 * nz / (args.n * (N - 1)),
                              y[:, 0].min(), y[:, 0].max()))
    np.savez_compressed(args.out, y=y, P=P, seed=args.seed,
                        newton=args.newton)
    print('wrote %s (%.1f MB)' % (args.out,
                                  os.path.getsize(args.out) / 1e6))


def main_pasr(args):
    """Sample the bench ensemble from a PaSR trajectory — the
    reference's own input pipeline (PaSR .npy -> data.bin,
    performance_tester.py:316-338).  Runs the framework's PaSR
    (testers/pasr.py, premixed case) on the flagship mechanism with a
    direct inlet composition (the synthetic species set has no literal
    fuel/O2 pair) and a hot inlet-composition pilot, then samples
    ``--n`` particle states across the trajectory's frames."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import _flagship_packed
    from pyjac_jax.ops.dydt import dydt
    from pyjac_jax.ops.jacobian import eval_jacobian
    from pyjac_jax.testers import pasr

    mech, packed = _flagship_packed()
    N = packed.n_species
    rng = np.random.default_rng(args.seed)

    # inlet: a handful of small species diluted in N2 (mole fractions,
    # original species order == internal order pre-pivot)
    names = list(mech.species_names)
    X = np.zeros(N)
    small = [i for i, nm in enumerate(names) if nm != 'N2'][:6]
    for i in small:
        X[i] = rng.uniform(0.05, 0.15)
    X[names.index('N2')] = 1.0 - X.sum() if X.sum() < 0.7 else 0.3
    X = X / X.sum()
    Y_react = pasr.mole_to_mass_fracs(packed, X)

    # pilot: the hot inlet relaxed onto the kinetic manifold with the
    # framework's own stiff integrator (scipy's BDF inside the PaSR
    # chemistry substep NaNs if particles start at the raw mixed
    # composition — the initial |dydt| is ~1e16)
    from pyjac_jax.integrate import integrate
    fw = np.asarray(mech.fwd_spec_mapping)
    y_cur = np.concatenate([[1900.0], Y_react[fw][:-1]])[None]
    P_pa = 10.0 * 101325.0
    # staged horizons: the raw mixed inlet sits ~5e16 K/s off the
    # manifold; restarting the integrator at growing horizons walks
    # through the transient (measured: T 1900 -> ~1130 K, then steady)
    for horizon, steps in ((1e-7, 2000), (1e-6, 2000), (1e-5, 5000),
                           (1e-4, 10000), (2e-3, 20000)):
        res = integrate(packed, jnp.asarray(y_cur), jnp.asarray([P_pa]),
                        horizon, rtol=1e-6, atol=1e-12,
                        max_steps=steps)
        y_cur = np.asarray(res.y)
    yp = y_cur[0]
    assert np.isfinite(yp).all() and int(np.asarray(res.status)[0]) == 0
    T_pilot = float(yp[0])
    # stream rows hold mass fractions in INTERNAL (packed) order, like
    # mole_to_mass_fracs output
    Y_pilot = np.concatenate([yp[1:], [1.0 - yp[1:].sum()]])
    print('pilot relaxed: T = %.1f K' % T_pilot)

    # inlet: micro-relax the raw mix at the inlet temperature so
    # arriving particles start within scipy-BDF reach of the manifold
    # (still unburned: 1 us at 1000 K only damps the fastest modes)
    y_in = np.concatenate([[1000.0], Y_react[fw][:-1]])[None]
    for horizon, steps in ((1e-8, 2000), (1e-7, 2000), (1e-6, 5000)):
        res_in = integrate(packed, jnp.asarray(y_in),
                           jnp.asarray([P_pa]), horizon, rtol=1e-6,
                           atol=1e-12, max_steps=steps)
        y_in = np.asarray(res_in.y)
    assert np.isfinite(y_in).all()
    Y_in_int = np.concatenate([y_in[0, 1:],
                               [1.0 - y_in[0, 1:].sum()]])
    X_in = Y_in_int * np.asarray(packed.inv_mw)
    X_in = X_in / X_in.sum()
    print('inlet micro-relaxed: T drift %.1f K' % (y_in[0, 0] - 1000.0))

    data = pasr.run_simulation(
        mech, 'premixed', init_temp=1000.0, pres=10.0, eq_ratio=1.0,
        fuel={}, oxidizer={}, num_part=96, tau_res=2e-3, tau_mix=1e-3,
        tau_pair=1e-3, num_res=2, seed=args.seed, verbose=True,
        inlet_X=X_in, pilot=(T_pilot, Y_pilot),
        chem_tols=(1e-5, 1e-9, 3000))
    frames = data.reshape(-1, data.shape[-1])    # (t, T, P, Y orig)
    print('PaSR frames: %s -> %d states' % (data.shape, len(frames)))

    sel = rng.choice(len(frames), size=min(args.n, len(frames)),
                     replace=len(frames) < args.n)
    fw = np.asarray(mech.fwd_spec_mapping)
    T = frames[sel, 1]
    P = frames[sel, 2]
    Yint = frames[sel, 3:][:, fw]
    y = np.concatenate([T[:, None], Yint[:, :-1]], axis=1)

    f = np.asarray(dydt(packed, 0.0, jnp.asarray(P), jnp.asarray(y)))
    J = np.asarray(eval_jacobian(packed, 0.0, jnp.asarray(P),
                                 jnp.asarray(y)))
    assert np.isfinite(f).all() and np.isfinite(J).all()
    print('states: %d, T %.0f..%.0f K, max|dT/dt| %.3e K/s' %
          (len(y), T.min(), T.max(), np.abs(f[:, 0]).max()))
    np.savez_compressed(args.out, y=y, P=P, seed=args.seed,
                        source='pasr')
    print('wrote %s (%.1f MB)' % (args.out,
                                  os.path.getsize(args.out) / 1e6))


if __name__ == '__main__':
    main()
