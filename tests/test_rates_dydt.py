"""Rate and dy/dt kernel tests against the independent NumPy oracle,
on the in-repo 12/30 mechanism and an all-features synthetic mechanism
(PLOG / Chebyshev / SRI / chemically-activated / fractional nu)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pyjac_jax.core.mech import Mechanism
from pyjac_jax.core.pack import pack
from pyjac_jax.ops import dydt as dydt_mod
from pyjac_jax.ops import rates, thermo
from pyjac_jax.testers import numpy_oracle as oracle
from pyjac_jax.testers.synthetic import random_states, synthetic_mechanism

RTOL = 1e-10


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    path = tmp_path_factory.mktemp('mech') / 'synth.inp'
    path.write_text(synthetic_mechanism(n_species=9, n_reactions=24, seed=7))
    mech = Mechanism.from_files(str(path))
    return mech, pack(mech)


def _compare_states(mech, packed, y, T, P, rtol=RTOL, n_check=25):
    Tj = jnp.asarray(T)
    Pj = jnp.asarray(P)
    Yj = jnp.asarray(y[:, 1:])
    _, _, _, conc = thermo.eval_conc(packed, Tj, Pj, Yj)
    fwd, rev = rates.eval_rxn_rates(packed, Tj, Pj, conc)
    pm = rates.get_rxn_pres_mod(packed, Tj, Pj, conc)
    wdot = rates.eval_spec_rates(packed, fwd, rev, pm)
    f = dydt_mod.dydt_conp(packed, 0.0, Pj, jnp.asarray(y))

    nu_abs = np.abs(np.asarray(packed.nu_net))
    mw = np.asarray(packed.mw)
    idx = np.linspace(0, len(T) - 1, n_check).astype(int)
    for i in idx:
        o = oracle.evaluate(mech, float(T[i]), float(P[i]), y[i, 1:])
        np.testing.assert_allclose(np.asarray(fwd[i]), o['fwd'], rtol=rtol,
                                   atol=1e-280, err_msg='fwd state %d' % i)
        np.testing.assert_allclose(np.asarray(rev[i]), o['rev'], rtol=rtol,
                                   atol=1e-280, err_msg='rev state %d' % i)
        np.testing.assert_allclose(np.asarray(pm[i]), o['pres_mod'],
                                   rtol=rtol, err_msg='pm state %d' % i)
        # near equilibrium fwd - rev cancels catastrophically; the
        # numerically meaningful scale is the *gross* flux, which is also
        # what the reference's thresholded error metric normalises by
        # (reference: functional_tester/test.py:1429-1472)
        gross = o['pres_mod'] * (np.abs(o['fwd']) + np.abs(o['rev']))
        wscale = (gross @ nu_abs).max() + 1e-300
        np.testing.assert_allclose(np.asarray(wdot[i]) / wscale,
                                   o['wdot'] / wscale, rtol=0, atol=rtol,
                                   err_msg='wdot state %d' % i)
        fscale = max((gross @ nu_abs * mw).max() / o['rho'],
                     abs(o['dydt'][0])) + 1e-300
        np.testing.assert_allclose(np.asarray(f[i]) / fscale,
                                   o['dydt'] / fscale, rtol=0, atol=rtol,
                                   err_msg='dydt state %d' % i)


def test_small_vs_oracle(small_mech, small_packed, small_states):
    st = small_states
    _compare_states(small_mech, small_packed, st['y'], st['T'], st['P'])


def test_synthetic_vs_oracle(synth):
    mech, packed = synth
    assert packed.has_plog and packed.has_cheb and packed.has_sri
    assert packed.has_chemact and packed.has_frac_nu
    y, T, P = random_states(mech, 64, seed=11)
    _compare_states(mech, packed, y, T, P, rtol=1e-9, n_check=64)


def test_conv_vs_oracle(small_mech, small_packed, small_states):
    st = small_states
    T = jnp.asarray(st['T'])
    P = jnp.asarray(st['P'])
    Y = jnp.asarray(st['Y_full'][:, :-1])
    _, _, rho, _ = thermo.eval_conc(small_packed, T, P, Y)
    rho_np = np.asarray(rho)
    f = dydt_mod.dydt_conv(small_packed, 0.0, rho, jnp.asarray(st['y']))
    nu_abs = np.abs(np.asarray(small_packed.nu_net))
    mw = np.asarray(small_packed.mw)
    for i in (0, 17, 150, 231, 255):
        o = oracle.evaluate_conv(small_mech, float(st['T'][i]), rho_np[i],
                                 st['Y_full'][i, :-1])
        gross = o['pres_mod'] * (np.abs(o['fwd']) + np.abs(o['rev']))
        fscale = max((gross @ nu_abs * mw).max() / rho_np[i],
                     abs(o['dydt'][0])) + 1e-300
        np.testing.assert_allclose(np.asarray(f[i]) / fscale,
                                   o['dydt'] / fscale, rtol=0, atol=RTOL)


def test_mass_conservation(small_packed, small_states):
    """sum_k W_k omega_k = 0 exactly (up to roundoff) for real mechanisms."""
    st = small_states
    T = jnp.asarray(st['T'])
    P = jnp.asarray(st['P'])
    Y = jnp.asarray(st['Y_full'][:, :-1])
    _, _, _, conc = thermo.eval_conc(small_packed, T, P, Y)
    fwd, rev = rates.eval_rxn_rates(small_packed, T, P, conc)
    pm = rates.get_rxn_pres_mod(small_packed, T, P, conc)
    wdot = rates.eval_spec_rates(small_packed, fwd, rev, pm)
    mass = np.asarray(jnp.einsum('bn,n->b', wdot, jnp.asarray(
        small_packed.mw)))
    scale = float(jnp.abs(wdot * jnp.asarray(small_packed.mw)).max())
    assert np.abs(mass).max() / scale < 1e-12


def test_compact_layouts(small_packed, small_states):
    st = small_states
    T = jnp.asarray(st['T'][:4])
    P = jnp.asarray(st['P'][:4])
    Y = jnp.asarray(st['Y_full'][:4, :-1])
    _, _, _, conc = thermo.eval_conc(small_packed, T, P, Y)
    fwd, rev = rates.eval_rxn_rates(small_packed, T, P, conc)
    pm = rates.get_rxn_pres_mod(small_packed, T, P, conc)
    crev = rates.compact_rev(small_packed, rev)
    cpm = rates.compact_pres_mod(small_packed, pm)
    assert crev.shape[-1] == small_packed.n_rev
    assert cpm.shape[-1] == small_packed.n_pres_mod == 5


def test_jit_and_vmap_compatible(small_packed, small_states):
    """Kernels must be jittable and produce identical results."""
    import jax
    st = small_states
    y = jnp.asarray(st['y'][:32])
    P = jnp.asarray(st['P'][:32])
    f_eager = np.asarray(dydt_mod.dydt_conp(small_packed, 0.0, P, y))
    f_jit = np.asarray(jax.jit(
        lambda p, yy: dydt_mod.dydt_conp(small_packed, 0.0, p, yy))(P, y))
    # XLA fusion may reassociate the cancelling fwd-rev sums; compare on
    # the per-state *gross flux* scale (near equilibrium the net dy/dt is
    # orders of magnitude below the gross rates)
    T, Y = y[..., 0], y[..., 1:]
    _, _, rho, conc = thermo.eval_conc(small_packed, T, P, Y)
    fwd, rev = rates.eval_rxn_rates(small_packed, T, P, conc)
    pm = rates.get_rxn_pres_mod(small_packed, T, P, conc)
    gross = np.asarray(pm * (jnp.abs(fwd) + jnp.abs(rev)))
    nu_abs = np.abs(np.asarray(small_packed.nu_net))
    mw = np.asarray(small_packed.mw)
    scale = ((gross @ nu_abs) * mw / np.asarray(rho)[:, None]).max(
        axis=-1, keepdims=True)
    scale = np.maximum(scale, np.abs(f_eager).max(axis=-1, keepdims=True))
    np.testing.assert_allclose(f_eager / scale, f_jit / scale, atol=1e-11)


def test_log_path_sign_on_plog_placeholder(tmp_path):
    """A PLOG/Chebyshev row whose *placeholder* main Arrhenius line has
    A = 0 (sign packed as 0) must still get its full rate through the
    log-space path: eval_kf applies the sign BEFORE the PLOG/Cheb
    overwrite, so the log path must neutralise the sign on overwritten
    rows (round-2 advisor finding: the log path zeroed such rows,
    corrupting the on-device AD oracle)."""
    import re

    from pyjac_jax.testers.synthetic import random_states

    text = synthetic_mechanism(n_species=9, n_reactions=24, seed=7)
    lines = text.splitlines()
    # zero the main-line A of the reaction carrying PLOG aux cards
    first_plog = next(k for k, ln in enumerate(lines) if 'PLOG' in ln)
    main = next(k for k in range(first_plog - 1, -1, -1)
                if '<=>' in lines[k])
    lines[main] = re.sub(r'\d\.\d+E\+\d+', '0.000E+00', lines[main],
                        count=1)
    path = tmp_path / 'm.inp'
    path.write_text('\n'.join(lines))
    mech = Mechanism.from_files(str(path))
    packed = pack(mech)
    assert packed.has_plog and packed.has_negative_A
    plog_rows = np.asarray(packed.plog_idx)
    assert (np.asarray(packed.A_sign)[plog_rows] == 0.0).any()

    y, T, P = random_states(mech, 16, seed=3)
    Tj, Pj = jnp.asarray(T), jnp.asarray(P)
    _, _, _, conc = thermo.eval_conc(packed, Tj, Pj, jnp.asarray(y[:, 1:]))
    fwd_lin, rev_lin = rates.eval_rxn_rates(packed, Tj, Pj, conc)
    fwd_log, rev_log = rates.eval_rxn_rates_log(packed, Tj, Pj, conc)
    assert np.asarray(fwd_lin)[:, plog_rows].all(), 'PLOG rows inactive'
    np.testing.assert_allclose(np.asarray(fwd_log), np.asarray(fwd_lin),
                               rtol=1e-8, atol=1e-300)
    np.testing.assert_allclose(np.asarray(rev_log), np.asarray(rev_lin),
                               rtol=1e-8, atol=1e-300)


def test_zero_pre_exponential_factor(tmp_path):
    """A = 0 packs as a dead reaction (sign 0) with finite derivatives
    instead of raising (reference emits the zero textually,
    rate_subs.py:27-146)."""
    import jax.numpy as jnp

    from pyjac_jax.core.mech import Mechanism
    from pyjac_jax.core.pack import pack
    from pyjac_jax.ops.jacobian import eval_jacobian, jacobian_fwd
    from pyjac_jax.ops.rates import eval_rxn_rates
    from pyjac_jax.ops.thermo import eval_conc
    from pyjac_jax.testers.synthetic import synthetic_mechanism

    text = synthetic_mechanism(n_species=9, n_reactions=12, seed=2,
                               all_features=False)
    # zero out one reaction's pre-exponential factor
    lines = text.splitlines()
    for k, ln in enumerate(lines):
        if '<=>' in ln and 'E+' in ln.upper():
            import re
            lines[k] = re.sub(r'\d\.\d+E\+\d+', '0.000E+00', ln, count=1)
            break
    path = tmp_path / 'm.inp'
    path.write_text('\n'.join(lines))
    mech = Mechanism.from_files(str(path))
    packed = pack(mech)
    assert (packed.A_sign == 0.0).sum() == 1
    dead = int(np.argwhere(packed.A_sign == 0.0)[0][0])

    from pyjac_jax.testers.synthetic import random_states
    y, T, P = random_states(mech, 8, seed=1)
    _, _, _, conc = eval_conc(packed, jnp.asarray(T), jnp.asarray(P),
                              jnp.asarray(y[:, 1:]))
    fwd, rev = eval_rxn_rates(packed, jnp.asarray(T), jnp.asarray(P), conc)
    assert np.all(np.asarray(fwd)[:, dead] == 0.0)
    assert np.all(np.asarray(rev)[:, dead] == 0.0)
    J = eval_jacobian(packed, 0.0, jnp.asarray(P), jnp.asarray(y))
    Jf = jacobian_fwd(packed, 0.0, jnp.asarray(P), jnp.asarray(y))
    assert np.isfinite(np.asarray(J)).all()
    scale = np.abs(np.asarray(Jf)).max()
    assert np.abs(np.asarray(J) - np.asarray(Jf)).max() / scale < 1e-10
