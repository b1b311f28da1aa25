"""The f64 Jacobian and dy/dt over every synthetic mechanism class, in
CONP and CONV.

Each case checks ``eval_jacobian`` against forward-mode AD of dy/dt
(``jacobian_fwd``) and the fused dy/dt against the independent,
loop-based NumPy oracle (``testers/numpy_oracle``).  The classes cover
every rate form the reference generates code for: the 9/24 all-features
mechanism (PLOG, Chebyshev, SRI, chemically-activated, fractional
orders, negative A), fractional orders at a larger size, the GRI-3.0
category mix, the element-balanced flagship family, and equilibrium
constants far beyond the f32 range (kr ~ 1e39).  The 654-species class
is checked for shapes only (it traces at any size; its numerics are the
slow tests').
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pyjac_jax.core.mech import Mechanism
from pyjac_jax.core.pack import pack
from pyjac_jax.ops.jacobian import jacobian_and_dydt, jacobian_fwd
from pyjac_jax.ops.thermo import eval_conc
from pyjac_jax.testers import numpy_oracle
from pyjac_jax.testers.synthetic import (plausible_mechanism, random_states,
                                         synthetic_mechanism, tiny_mechanism)


def _extreme_states(n=8, seed=0):
    """Trace-level product states of ``tiny_mechanism``: kr = kf/Kc
    reaches ~1e39 while every finished Jacobian entry stays moderate."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(1000.0, 1400.0, n)
    Y = np.zeros((n, 3))
    Y[:, 0] = rng.uniform(0.1, 0.3, n)
    Y[:, 1] = rng.uniform(0.2, 0.5, n)
    Y[:, 2] = 10.0 ** rng.uniform(-7, -5.5, n)
    return np.concatenate([T[:, None], Y], axis=1), T, np.full(n, 1.01325e6)


CASES = {
    'all_features_9_24': (
        lambda: synthetic_mechanism(n_species=9, n_reactions=24, seed=7),
        lambda m: random_states(m, 8, seed=3)),
    'frac_nu_13_40': (
        lambda: synthetic_mechanism(n_species=13, n_reactions=40, seed=3),
        lambda m: random_states(m, 8, seed=5)),
    'gri_mix_21_60': (
        lambda: synthetic_mechanism(n_species=21, n_reactions=60, seed=11,
                                    gri_mix=True),
        lambda m: random_states(m, 8, seed=2)),
    'plausible_16_48': (
        lambda: plausible_mechanism(16, 48, seed=4),
        lambda m: random_states(m, 8, seed=6, T_range=(1000.0, 2000.0))),
    'extreme_kc': (
        lambda: tiny_mechanism(a5x=36000.0),
        lambda m: _extreme_states()),
}


@pytest.fixture(scope='module')
def built(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            text, states = CASES[name]
            path = tmp_path_factory.mktemp(name) / (name + '.inp')
            path.write_text(text())
            mech = Mechanism.from_files(str(path))
            y, _, P = states(mech)
            cache[name] = (mech, pack(mech), np.asarray(y, np.float64),
                           np.asarray(P, np.float64))
        return cache[name]
    return get


def _floored_max_rel(a, b, floor):
    a = np.asarray(a).reshape(len(a), -1)
    b = np.asarray(b).reshape(len(b), -1)
    denom = np.maximum(np.abs(b),
                       np.abs(b).max(-1, keepdims=True) * floor + 1e-300)
    return float((np.abs(a - b) / denom).max())


@pytest.mark.parametrize('conp', [True, False], ids=['conp', 'conv'])
@pytest.mark.parametrize('name', sorted(CASES))
def test_jacobian_and_dydt_f64(built, name, conp):
    mech, packed, y, P = built(name)
    if name == 'all_features_9_24':
        assert packed.has_plog and packed.has_cheb and packed.has_sri
        assert packed.has_chemact and packed.has_frac_nu
    if name == 'frac_nu_13_40':
        assert packed.has_frac_nu
    if name == 'extreme_kc':
        from pyjac_jax.ops.rates import eval_kc, eval_kf
        T, Pj = jnp.asarray(y[:, 0]), jnp.asarray(P)
        kr = np.asarray(eval_kf(packed, T, Pj)) / np.asarray(
            eval_kc(packed, T))
        assert kr.max() > 1e39          # beyond the f32 exponent range
    yj = jnp.asarray(y)
    if conp:
        param = jnp.asarray(P)
    else:
        _, _, param, _ = eval_conc(packed, yj[:, 0], jnp.asarray(P),
                                   yj[:, 1:])
    J, f = jax.jit(lambda p, yy: jacobian_and_dydt(packed, 0.0, p, yy,
                                                   conp=conp))(param, yj)
    J_ad = jacobian_fwd(packed, 0.0, param, yj, conp=conp)
    assert np.isfinite(np.asarray(J)).all()
    err = _floored_max_rel(J, J_ad, 1e-9)
    assert err < 1e-8, 'J vs forward AD: %.3e' % err

    # dy/dt against the NumPy oracle, scaled by the gross fluxes (the
    # net rates of near-equilibrium rows cancel)
    f = np.asarray(f)
    nu_abs = np.abs(np.asarray(packed.nu_net))
    mw = np.asarray(packed.mw)
    param = np.asarray(param)
    for i in range(len(y)):
        if conp:
            o = numpy_oracle.evaluate(mech, y[i, 0], P[i], y[i, 1:])
        else:
            o = numpy_oracle.evaluate_conv(mech, y[i, 0], param[i],
                                           y[i, 1:])
        gross = o['pres_mod'] * (np.abs(o['fwd']) + np.abs(o['rev']))
        scale = max((gross @ nu_abs * mw).max() / o['rho'],
                    abs(o['dydt'][0])) + 1e-300
        np.testing.assert_allclose(f[i] / scale, o['dydt'] / scale,
                                   rtol=0, atol=1e-9,
                                   err_msg='%s state %d' % (name, i))


@pytest.mark.parametrize('conp', [True, False], ids=['conp', 'conv'])
def test_654_class_traces_at_any_size(tmp_path_factory, conp):
    """The n-heptane class (654 species / 2716 reactions) traces through
    the same f64 path: shapes and dtypes only, no compile."""
    path = tmp_path_factory.mktemp('big') / 'big.inp'
    path.write_text(plausible_mechanism(654, 2716, seed=5))
    packed = pack(Mechanism.from_files(str(path)))
    N = packed.n_species
    y = jax.ShapeDtypeStruct((4, N), jnp.float64)
    p = jax.ShapeDtypeStruct((4,), jnp.float64)
    J, f = jax.eval_shape(lambda pp, yy: jacobian_and_dydt(
        packed, 0.0, pp, yy, conp=conp), p, y)
    assert J.shape == (4, N, N) and f.shape == (4, N)
    assert J.dtype == f.dtype == jnp.float64
