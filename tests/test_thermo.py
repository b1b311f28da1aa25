"""Thermo kernel tests: NASA-7 property evaluation vs the independent
NumPy oracle, thermodynamic identities, and derivative tables."""

import jax.numpy as jnp
import numpy as np
import pytest

from pyjac_jax.core.constants import RU
from pyjac_jax.ops import thermo
from pyjac_jax.testers import numpy_oracle as oracle


@pytest.fixture(scope='module')
def temps():
    # straddle the T_mid boundary on purpose
    return np.array([300.0, 650.0, 999.9, 1000.0, 1000.1, 1500.0, 2500.0,
                     3400.0])


def test_properties_vs_oracle(small_mech, small_packed, temps):
    T = jnp.asarray(temps)
    cp = np.asarray(thermo.eval_cp(small_packed, T))
    h = np.asarray(thermo.eval_h(small_packed, T))
    u = np.asarray(thermo.eval_u(small_packed, T))
    cv = np.asarray(thermo.eval_cv(small_packed, T))
    s = np.asarray(thermo.eval_smh(small_packed, T))
    for i, Tv in enumerate(temps):
        for j, sp in enumerate(small_mech.specs):
            assert cp[i, j] == pytest.approx(oracle.cp_mass(sp, Tv),
                                             rel=1e-13)
            assert h[i, j] == pytest.approx(oracle.h_mass(sp, Tv), rel=1e-13)
            assert u[i, j] == pytest.approx(oracle.u_mass(sp, Tv), rel=1e-13)
            assert cv[i, j] == pytest.approx(oracle.cv_mass(sp, Tv),
                                             rel=1e-13)
            assert s[i, j] == pytest.approx(oracle.smh(sp, Tv), rel=1e-12)


def test_identities(small_packed, temps):
    """h - u = (R/W) T and cp - cv = R/W for ideal gases."""
    T = jnp.asarray(temps)
    h = np.asarray(thermo.eval_h(small_packed, T))
    u = np.asarray(thermo.eval_u(small_packed, T))
    cp = np.asarray(thermo.eval_cp(small_packed, T))
    cv = np.asarray(thermo.eval_cv(small_packed, T))
    RW = RU / small_packed.mw
    np.testing.assert_allclose(h - u, np.outer(temps, RW), rtol=1e-10)
    np.testing.assert_allclose(cp - cv, np.broadcast_to(RW, cp.shape),
                               rtol=1e-10)


def test_dsmh_dT_matches_fd(small_packed):
    """The packed dB/dT table must equal d(smh)/dT."""
    T0 = 1234.5
    eps = 1e-4
    d = np.asarray(thermo.eval_dsmh_dT(small_packed, jnp.asarray([T0])))[0]
    sp_hi = np.asarray(thermo.eval_smh(small_packed, jnp.asarray([T0 + eps])))
    sp_lo = np.asarray(thermo.eval_smh(small_packed, jnp.asarray([T0 - eps])))
    fd = (sp_hi - sp_lo)[0] / (2 * eps)
    np.testing.assert_allclose(d, fd, rtol=1e-7)


def test_dcp_dT_matches_fd(small_packed):
    T0 = 987.0  # below all T_mid
    eps = 1e-4
    d = np.asarray(thermo.eval_dcp_dT(small_packed, jnp.asarray([T0])))[0]
    hi = np.asarray(thermo.eval_cp(small_packed, jnp.asarray([T0 + eps])))
    lo = np.asarray(thermo.eval_cp(small_packed, jnp.asarray([T0 - eps])))
    fd = (hi - lo)[0] / (2 * eps)
    # atomic species have cp ~ const: both sides are FD-level noise there
    np.testing.assert_allclose(d, fd, rtol=1e-6, atol=1e-7)


def test_eval_conc(small_mech, small_packed, small_states):
    st = small_states
    T = jnp.asarray(st['T'])
    P = jnp.asarray(st['P'])
    Y = jnp.asarray(st['Y_full'][:, :-1])
    y_N, mw_avg, rho, conc = thermo.eval_conc(small_packed, T, P, Y)
    for i in (0, 100, 200, 255):
        o_yN, o_mw, o_rho, o_conc = oracle.concentrations(
            small_mech, st['T'][i], st['P'][i], st['Y_full'][i, :-1])
        assert float(y_N[i]) == pytest.approx(o_yN, abs=1e-14)
        assert float(mw_avg[i]) == pytest.approx(o_mw, rel=1e-13)
        assert float(rho[i]) == pytest.approx(o_rho, rel=1e-13)
        np.testing.assert_allclose(np.asarray(conc[i]), o_conc, rtol=1e-12,
                                   atol=1e-300)


def test_conc_rho_roundtrip(small_packed, small_states):
    """CONP -> CONV roundtrip: density from eval_conc reproduces pressure."""
    st = small_states
    T = jnp.asarray(st['T'])
    P = jnp.asarray(st['P'])
    Y = jnp.asarray(st['Y_full'][:, :-1])
    _, _, rho, conc = thermo.eval_conc(small_packed, T, P, Y)
    _, _, P2, conc2 = thermo.eval_conc_rho(small_packed, T, rho, Y)
    np.testing.assert_allclose(np.asarray(P2), st['P'], rtol=1e-12)
    np.testing.assert_allclose(np.asarray(conc2), np.asarray(conc),
                               rtol=1e-12)
