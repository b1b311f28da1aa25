"""Thermodynamic property kernels (NASA-7 polynomials), batched over states.

Equivalents of the reference's generated ``chem_utils``
(reference: pyjac/core/rate_subs.py:1545-2090 — eval_conc, eval_conc_rho,
eval_h, eval_u, eval_cp, eval_cv) and of ``calc_spec_smh``
(reference: pyjac/core/chem_utilities.py:257-300).

All functions take states with arbitrary leading batch dimensions:
``T`` has shape ``(...,)``, mass fractions ``Y`` have shape
``(..., N-1)`` (the last species is eliminated via ``1 - sum(Y)``).
Per-species outputs have shape ``(..., N)``.

The two-range NASA polynomial switch is evaluated as both branches plus a
``jnp.where`` on ``T <= T_mid`` — branch-free, batch-friendly, exactly
the semantics of the emitted ``if (T <= Tmid)`` conditionals.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.constants import RU
from .common import f


def _dual(packed, T, poly):
    """Evaluate ``poly(coeffs, T)`` on both NASA ranges and select."""
    Tb = T[..., None]
    lo = poly(f(packed.a_lo), Tb)
    hi = poly(f(packed.a_hi), Tb)
    return jnp.where(Tb <= f(packed.T_mid), lo, hi)


# --- dimensionless / mass-specific property polynomials -----------------------

def _cp_R(a, T):
    return a[..., 0] + T * (a[..., 1] + T * (a[..., 2] + T * (
        a[..., 3] + a[..., 4] * T)))


def _h_mass_poly(a, T):
    # h = RU/W * (a5 + T*(a0 + T*(a1/2 + T*(a2/3 + T*(a3/4 + a4/5*T)))))
    # (reference grouping: rate_subs.py eval_h emission)
    return a[..., 5] + T * (a[..., 0] + T * (a[..., 1] / 2.0 + T * (
        a[..., 2] / 3.0 + T * (a[..., 3] / 4.0 + a[..., 4] / 5.0 * T))))


def _u_mass_poly(a, T):
    return a[..., 5] + T * (a[..., 0] - 1.0 + T * (a[..., 1] / 2.0 + T * (
        a[..., 2] / 3.0 + T * (a[..., 3] / 4.0 + a[..., 4] / 5.0 * T))))


def _smh_poly(a, T):
    # standard-state entropy minus enthalpy, S/R - H/(RT)
    # (reference: chem_utilities.py:286-296)
    logT = jnp.log(T)
    return (a[..., 0] * (logT - 1.0) + T * (a[..., 1] / 2.0 + T * (
        a[..., 2] / 6.0 + T * (a[..., 3] / 12.0 + a[..., 4] / 20.0 * T)))
        - a[..., 5] / T + a[..., 6])


def _dsmh_dT_poly(a, T):
    # d(smh)/dT — the reference's dB/dT table
    # (reference: create_jacobian.py:761-950)
    return (a[..., 0] / T + a[..., 1] / 2.0 + T * (a[..., 2] / 3.0 + T * (
        a[..., 3] / 4.0 + a[..., 4] / 5.0 * T)) + a[..., 5] / (T * T))


def _dcp_R_dT(a, T):
    return a[..., 1] + T * (2.0 * a[..., 2] + T * (3.0 * a[..., 3] +
                                                   4.0 * a[..., 4] * T))


# --- public kernels -------------------------------------------------------------

def eval_cp(packed, T):
    """Constant-pressure specific heat per species [J/(kg K)], (..., N)."""
    return (RU * f(packed.inv_mw)) * _dual(packed, T, _cp_R)


def eval_cv(packed, T):
    """Constant-volume specific heat per species [J/(kg K)], (..., N)."""
    return (RU * f(packed.inv_mw)) * (_dual(packed, T, _cp_R) - 1.0)


def eval_h(packed, T):
    """Enthalpy per species [J/kg], (..., N)."""
    return (RU * f(packed.inv_mw)) * _dual(packed, T, _h_mass_poly)


def eval_u(packed, T):
    """Internal energy per species [J/kg], (..., N)."""
    return (RU * f(packed.inv_mw)) * _dual(packed, T, _u_mass_poly)


def eval_smh(packed, T):
    """Standard-state S/R - H/(RT) per species, (..., N)."""
    return _dual(packed, T, _smh_poly)


def eval_dsmh_dT(packed, T):
    """Temperature derivative of :func:`eval_smh`, (..., N)."""
    return _dual(packed, T, _dsmh_dT_poly)


def eval_dcp_dT(packed, T):
    """d(cp)/dT per species [J/(kg K^2)], (..., N)."""
    return (RU * f(packed.inv_mw)) * _dual(packed, T, _dcp_R_dT)


def last_mass_fraction(Y):
    """Mass fraction of the eliminated species, ``1 - sum(Y)``."""
    return 1.0 - jnp.sum(Y, axis=-1)


def mean_molecular_weight(packed, Y):
    """Mixture mean molecular weight [kg/kmol] from the reduced Y vector."""
    y_N = last_mass_fraction(Y)
    inv_mw = f(packed.inv_mw)
    denom = jnp.sum(Y * inv_mw[:-1], axis=-1) + y_N * inv_mw[-1]
    return 1.0 / denom, y_N


def eval_conc(packed, T, pres, Y):
    """Species molar concentrations under known pressure (CONP path).

    Returns ``(y_N, mw_avg, rho, conc)`` matching the reference's
    ``eval_conc`` signature (rate_subs.py:1625-1706); ``conc`` has shape
    ``(..., N)`` in [kmol/m^3].
    """
    mw_avg, y_N = mean_molecular_weight(packed, Y)
    rho = pres * mw_avg / (RU * T)
    y_full = jnp.concatenate([Y, y_N[..., None]], axis=-1)
    conc = rho[..., None] * y_full * f(packed.inv_mw)
    return y_N, mw_avg, rho, conc


def eval_conc_rho(packed, T, rho, Y):
    """Species molar concentrations under known density (CONV path).

    Returns ``(y_N, mw_avg, pres, conc)``
    (reference: rate_subs.py eval_conc_rho emission).
    """
    mw_avg, y_N = mean_molecular_weight(packed, Y)
    pres = rho * RU * T / mw_avg
    y_full = jnp.concatenate([Y, y_N[..., None]], axis=-1)
    conc = rho[..., None] * y_full * f(packed.inv_mw)
    return y_N, mw_avg, pres, conc
