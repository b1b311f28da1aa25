"""Example: batched ignition-delay computation on the accelerator.

Computes ignition delays for a grid of H2/air initial temperatures and
equivalence ratios — every state integrated in parallel on-device with
the analytical Jacobian (Rosenbrock23). The reference workflow requires
exporting generated C into an external stiff integrator; here it is
five lines of JAX.

Run:  python examples/ignition_delay.py MECH

where MECH is an H2/O2 mechanism file (Chemkin or Cantera) that
contains H2, O2 and N2.
"""

import sys

import jax

jax.config.update('jax_enable_x64', True)

import numpy as np  # noqa: E402

import pyjac_jax as pj  # noqa: E402
from pyjac_jax.testers import pasr  # noqa: E402


def main():
    if len(sys.argv) != 2:
        raise SystemExit('usage: python examples/ignition_delay.py MECH')
    mech = pj.Mechanism.from_files(sys.argv[1])
    packed = pj.pack(mech)

    T0 = np.linspace(950.0, 1400.0, 10)
    phi = np.linspace(0.5, 2.0, 4)
    states = []
    for p in phi:
        X = pasr.equivalence_ratio_reactants(mech, p, {'H2': 1.0},
                                             {'O2': 1.0, 'N2': 3.76})
        Y = pasr.mole_to_mass_fracs(packed, X)
        for t in T0:
            states.append(np.concatenate([[t], Y[:-1]]))
    y0 = np.asarray(states)
    P = np.full(len(y0), 101325.0)

    tau = pj.ignition_delay(packed, y0, P, t_end=5e-3, rtol=1e-7)
    tau = tau.reshape(len(phi), len(T0))

    print('ignition delay [ms] (rows: phi, cols: T0)')
    print('T0[K]: ' + ' '.join('%7.0f' % t for t in T0))
    for i, p in enumerate(phi):
        print('phi=%.1f ' % p + ' '.join('%7.3f' % (t * 1e3)
                                         for t in tau[i]))


if __name__ == '__main__':
    main()
