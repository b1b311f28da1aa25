"""Analytical Jacobian vs forward-mode AD oracle.

The closed-form assembly in ops/jacobian.py must agree entrywise with
jax.jacfwd of dydt (the Adept-autodiff analog the reference validates
against, functional_tester/test.py:173-217, :1328) on every reaction
category, in both CONP and CONV regimes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pyjac_jax.core.mech import Mechanism
from pyjac_jax.core.pack import pack
from pyjac_jax.ops import thermo
from pyjac_jax.ops.jacobian import (eval_jacobian, jacobian_fwd,
                                    jacobian_vector_product)
from pyjac_jax.testers.synthetic import random_states, synthetic_mechanism


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    path = tmp_path_factory.mktemp('mech') / 'synth.inp'
    path.write_text(synthetic_mechanism(n_species=9, n_reactions=24,
                                        seed=7))
    mech = Mechanism.from_files(str(path))
    return mech, pack(mech)


def _assert_jac_close(J, J_ref, rtol=1e-8, floor_frac=1e-9):
    """Entrywise comparison with a per-state magnitude floor: entries
    below floor_frac * max|J| are compared absolutely (the reference's
    thresholded metric, functional_tester/test.py:1429-1472)."""
    J = np.asarray(J)
    J_ref = np.asarray(J_ref)
    scale = np.abs(J_ref).reshape(J_ref.shape[0], -1).max(axis=1)
    scale = scale.reshape((-1,) + (1,) * (J_ref.ndim - 1)) + 1e-300
    err = np.abs(J - J_ref)
    denom = np.maximum(np.abs(J_ref), floor_frac * scale)
    rel = (err / denom).max()
    assert rel < rtol, 'max thresholded rel err %.3e' % rel


def test_jacobian_conp_small(small_packed, small_states):
    st = small_states
    sel = np.linspace(0, len(st['T']) - 1, 40).astype(int)
    y = jnp.asarray(st['y'][sel])
    P = jnp.asarray(st['P'][sel])
    J = eval_jacobian(small_packed, 0.0, P, y, conp=True)
    J_ref = jacobian_fwd(small_packed, 0.0, P, y, conp=True)
    N = small_packed.n_species
    assert J.shape == J_ref.shape == (40, N, N)
    _assert_jac_close(J, J_ref)


def test_jacobian_conv_small(small_packed, small_states):
    st = small_states
    sel = np.linspace(0, len(st['T']) - 1, 25).astype(int)
    y = jnp.asarray(st['y'][sel])
    P = jnp.asarray(st['P'][sel])
    T = jnp.asarray(st['T'][sel])
    Y = jnp.asarray(st['Y_full'][sel, :-1])
    _, _, rho, _ = thermo.eval_conc(small_packed, T, P, Y)
    J = eval_jacobian(small_packed, 0.0, rho, y, conp=False)
    J_ref = jacobian_fwd(small_packed, 0.0, rho, y, conp=False)
    _assert_jac_close(J, J_ref)


def test_jacobian_conp_synthetic(synth):
    """Covers PLOG, Chebyshev, SRI, chemically-activated, fractional nu."""
    mech, packed = synth
    y, T, P = random_states(mech, 48, seed=5)
    J = eval_jacobian(packed, 0.0, jnp.asarray(P), jnp.asarray(y),
                      conp=True)
    J_ref = jacobian_fwd(packed, 0.0, jnp.asarray(P), jnp.asarray(y),
                         conp=True)
    _assert_jac_close(J, J_ref)


def test_jacobian_conv_synthetic(synth):
    mech, packed = synth
    y, T, P = random_states(mech, 32, seed=9)
    _, _, rho, _ = thermo.eval_conc(packed, jnp.asarray(T), jnp.asarray(P),
                                    jnp.asarray(y[:, 1:]))
    J = eval_jacobian(packed, 0.0, rho, jnp.asarray(y), conp=False)
    J_ref = jacobian_fwd(packed, 0.0, rho, jnp.asarray(y), conp=False)
    _assert_jac_close(J, J_ref)


def test_jvp_matches_jacobian(small_packed, small_states):
    """The sparse_multiplier analog: J @ v via jvp equals explicit J @ v."""
    st = small_states
    y = jnp.asarray(st['y'][:8])
    P = jnp.asarray(st['P'][:8])
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal(y.shape))
    J = jacobian_fwd(small_packed, 0.0, P, y, conp=True)
    jv = jacobian_vector_product(small_packed, 0.0, P, y, v, conp=True)
    ref = np.einsum('bij,bj->bi', np.asarray(J), np.asarray(v))
    scale = np.abs(ref).max() + 1e-300
    np.testing.assert_allclose(np.asarray(jv) / scale, ref / scale,
                               atol=1e-10)


def test_jacobian_single_state(small_packed, small_states):
    """Unbatched call works too."""
    st = small_states
    y = jnp.asarray(st['y'][3])
    P = float(st['P'][3])
    J = eval_jacobian(small_packed, 0.0, P, y, conp=True)
    J_ref = jacobian_fwd(small_packed, 0.0, P, y, conp=True)
    assert J.shape == (small_packed.n_species,) * 2
    _assert_jac_close(J[None], J_ref[None])


def test_log_space_ad_oracle_matches_linear(small_packed, small_states):
    """jacobian_fwd(log_space=True) differentiates the range-safe
    log-space dydt and must agree with the linear-space AD (which is
    exact on CPU f64) — the on-device oracle path (VERDICT r1 item 3)."""
    import jax.numpy as jnp
    import numpy as np

    from pyjac_jax.ops.jacobian import jacobian_fwd
    y = jnp.asarray(small_states['y'][:48])
    P = jnp.asarray(small_states['P'][:48])
    J_lin = np.asarray(jacobian_fwd(small_packed, 0.0, P, y))
    J_log = np.asarray(jacobian_fwd(small_packed, 0.0, P, y,
                                    log_space=True))
    scale = np.abs(J_lin).max()
    assert np.abs(J_log - J_lin).max() / scale < 1e-10
