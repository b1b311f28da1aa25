"""State derivative dy/dt under constant pressure (CONP) or constant
volume (CONV), batched over states.

Equivalent of the reference's generated ``dydt`` source
(reference: pyjac/core/rate_subs.py:2093-2490 ``write_derivs``).

State layout matches the reference exactly: ``y = [T, Y_1 .. Y_{N-1}]``
with the last species eliminated via ``Y_N = 1 - sum(Y)``; shape
``(..., N)``. The second argument is pressure [Pa] for CONP and density
[kg/m^3] for CONV, broadcastable against the batch.
"""

from __future__ import annotations

import jax.numpy as jnp

from .rates import eval_rxn_rates, eval_spec_rates, get_rxn_pres_mod
from .thermo import (eval_conc, eval_conc_rho, eval_cp, eval_cv, eval_h,
                     eval_u)
from .common import f


def split_state(y):
    """(T, Y_reduced) from a packed state vector."""
    return y[..., 0], y[..., 1:]


def dydt_conp(packed, t, pres, y):
    """dy/dt at constant pressure (reference: rate_subs.py:2171-2335).

    dT/dt = -(1 / (rho cp_bar)) sum_k h_k W_k omega_k
    dY_k/dt = omega_k W_k / rho
    """
    T, Y = split_state(y)
    y_N, mw_avg, rho, conc = eval_conc(packed, T, pres, Y)
    fwd, rev = eval_rxn_rates(packed, T, pres, conc)
    pm = get_rxn_pres_mod(packed, T, pres, conc)
    wdot = eval_spec_rates(packed, fwd, rev, pm)          # (..., N)

    cp = eval_cp(packed, T)                                # (..., N)
    y_full = jnp.concatenate([Y, y_N[..., None]], axis=-1)
    cp_avg = jnp.sum(cp * y_full, axis=-1)
    h = eval_h(packed, T)

    mw = f(packed.mw)
    dT = -jnp.sum(h * mw * wdot, axis=-1) / (rho * cp_avg)
    dY = wdot[..., :-1] * mw[:-1] / rho[..., None]
    return jnp.concatenate([dT[..., None], dY], axis=-1)


def dydt_conv(packed, t, rho, y):
    """dy/dt at constant volume (reference: rate_subs.py:2337-2487).

    dT/dt = -(1 / (rho cv_bar)) sum_k u_k W_k omega_k
    """
    T, Y = split_state(y)
    y_N, mw_avg, pres, conc = eval_conc_rho(packed, T, rho, Y)
    fwd, rev = eval_rxn_rates(packed, T, pres, conc)
    pm = get_rxn_pres_mod(packed, T, pres, conc)
    wdot = eval_spec_rates(packed, fwd, rev, pm)

    cv = eval_cv(packed, T)
    y_full = jnp.concatenate([Y, y_N[..., None]], axis=-1)
    cv_avg = jnp.sum(cv * y_full, axis=-1)
    u = eval_u(packed, T)

    mw = f(packed.mw)
    dT = -jnp.sum(u * mw * wdot, axis=-1) / (rho * cv_avg)
    dY = wdot[..., :-1] * mw[:-1] / jnp.broadcast_to(
        jnp.asarray(rho), dT.shape)[..., None]
    return jnp.concatenate([dT[..., None], dY], axis=-1)


def dydt(packed, t, param, y, conp: bool = True):
    """Dispatch to :func:`dydt_conp` or :func:`dydt_conv` (the reference's
    compile-time CONP/CONV switch, mech_auxiliary.py:464-466)."""
    if conp:
        return dydt_conp(packed, t, param, y)
    return dydt_conv(packed, t, param, y)


def dydt_log(packed, t, param, y, conp: bool = True):
    """dy/dt with every rate evaluated in log space.

    Identical math to :func:`dydt` up to O(1e-25) concentration
    flooring; rate constants and concentration powers are combined as
    logarithms and exponentiated once per reaction, so forward-mode AD
    through it never forms the large linear-space kf/Kc tangents."""
    from .rates import eval_rxn_rates_log, get_rxn_pres_mod_log
    T, Y = split_state(y)
    if conp:
        y_N, mw_avg, rho, conc = eval_conc(packed, T, param, Y)
        pres = jnp.broadcast_to(jnp.asarray(param, dtype=y.dtype), T.shape)
    else:
        y_N, mw_avg, pres, conc = eval_conc_rho(packed, T, param, Y)
        rho = jnp.broadcast_to(jnp.asarray(param, dtype=y.dtype), T.shape)
    fwd, rev = eval_rxn_rates_log(packed, T, pres, conc)
    pm = get_rxn_pres_mod_log(packed, T, pres, conc)
    wdot = eval_spec_rates(packed, fwd, rev, pm)

    y_full = jnp.concatenate([Y, y_N[..., None]], axis=-1)
    mw = f(packed.mw)
    if conp:
        cp = eval_cp(packed, T)
        sh = jnp.sum(cp * y_full, axis=-1)
        e = eval_h(packed, T)
    else:
        cv = eval_cv(packed, T)
        sh = jnp.sum(cv * y_full, axis=-1)
        e = eval_u(packed, T)
    dT = -jnp.sum(e * mw * wdot, axis=-1) / (rho * sh)
    dY = wdot[..., :-1] * mw[:-1] / rho[..., None]
    return jnp.concatenate([dT[..., None], dY], axis=-1)
