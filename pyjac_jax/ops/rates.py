"""Reaction-rate kernels: forward/reverse rates of progress and pressure
modifications, batched over states.

Equivalents of the reference's generated ``rxn_rates`` and
``rxn_rates_pres_mod`` sources (reference: pyjac/core/rate_subs.py:254-877
``write_rxn_rates``, :879-1290 ``write_rxn_pressure_mod``).

Where pyJac emits straight-line code per reaction, these kernels
vectorise over *reaction categories* — elementary / PLOG / Chebyshev
forward constants; plain third-body / Lindemann / Troe / SRI falloff
pressure modifications — with masks, static trace-time pruning of absent
categories, and gathered index sets for the rare PLOG/Chebyshev rows.
All arrays are (batch..., R) with R the full reaction count; reverse
rates are zero on irreversible rows and ``pres_mod`` is one on rows
without third-body/falloff behaviour, which keeps the downstream
species-rate and Jacobian assembly a dense matmul.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from ..core.constants import PA, RU
from .common import LOG10, f, i, safe_log10
from .thermo import eval_smh

_LN_PA_RU = math.log(PA / RU)


# --------------------------------------------------------------------------
# forward rate constants
# --------------------------------------------------------------------------

def _arrhenius(logA, beta, Ta, T, logT):
    """exp(log A + beta log T - Ta / T) — the reference's folded form
    (reference: rate_subs.py:27-146 ``rxn_rate_const``).

    Parameter arrays are (R,); T/logT carry batch dims and gain a
    trailing reaction axis here.
    """
    return jnp.exp(logA + beta * logT[..., None] - Ta / T[..., None])


def _plog_logkf(packed, T, logT, pres):
    """log kf for PLOG rows: piecewise log-linear interpolation in ln P
    (reference: rate_subs.py:598-632). Returns (..., Rp)."""
    tab = f(packed.plog_lnP)                      # (Rp, P)
    n = i(packed.plog_n)                          # (Rp,)
    lnP = jnp.log(pres)
    # interval index: #breakpoints strictly below, clamped to [0, n-2]
    cnt = jnp.sum(lnP[..., None, None] > tab, axis=-1)     # (..., Rp)
    idx_lo = jnp.clip(cnt - 1, 0, jnp.maximum(n - 2, 0))
    idx_hi = jnp.minimum(idx_lo + 1, n - 1)

    lnk = (f(packed.plog_logA) + f(packed.plog_beta) * logT[..., None, None]
           - f(packed.plog_Ta) / T[..., None, None])       # (..., Rp, P)
    lo = jnp.take_along_axis(lnk, idx_lo[..., None], axis=-1)[..., 0]
    hi = jnp.take_along_axis(lnk, idx_hi[..., None], axis=-1)[..., 0]
    P_lo = jnp.take_along_axis(jnp.broadcast_to(tab, lnk.shape),
                               idx_lo[..., None], axis=-1)[..., 0]
    P_hi = jnp.take_along_axis(jnp.broadcast_to(tab, lnk.shape),
                               idx_hi[..., None], axis=-1)[..., 0]
    denom = P_hi - P_lo
    w = (lnP[..., None] - P_lo) / jnp.where(denom == 0.0, 1.0, denom)
    # clamping w to [0, 1] reproduces the constant extrapolation outside
    # the tabulated pressure range
    w = jnp.clip(w, 0.0, 1.0)
    return lo + (hi - lo) * w


def _cheb_pows(x, n: int):
    """First-kind Chebyshev polynomials T_0..T_{n-1}(x), stacked on a new
    trailing axis (static recurrence, reference: rate_subs.py:196-247)."""
    polys = [jnp.ones_like(x)]
    if n > 1:
        polys.append(x)
    for _ in range(2, n):
        polys.append(2.0 * x * polys[-1] - polys[-2])
    return jnp.stack(polys, axis=-1)


def _cheb_log10kf(packed, T, pres):
    """log10 kf for Chebyshev rows (reference: rate_subs.py:149-251).
    Returns (..., Rc)."""
    tl = f(packed.cheb_tlim)                       # (Rc, 2)
    pl = f(packed.cheb_plim)
    Tred = ((2.0 / T)[..., None] - tl[:, 0]) / tl[:, 1]
    Pred = (2.0 * safe_log10(pres)[..., None] - pl[:, 0]) / pl[:, 1]
    coef = f(packed.cheb_coef)                     # (Rc, NT, NP)
    Tp = _cheb_pows(Tred, coef.shape[1])           # (..., Rc, NT)
    Pp = _cheb_pows(Pred, coef.shape[2])           # (..., Rc, NP)
    return jnp.einsum('...ri,rij,...rj->...r', Tp, coef, Pp)


def eval_kf(packed, T, pres):
    """Forward rate constants for all reactions, (..., R).

    For falloff (LOW) rows this is the high-pressure limit and for
    chemically-activated (HIGH) rows the low-pressure limit, exactly as
    in the reference where ``pres_mod`` supplies the blending.
    """
    logT = jnp.log(T)
    kf = _arrhenius(f(packed.logA), f(packed.beta), f(packed.Ta), T, logT)
    if packed.has_negative_A:
        kf = kf * f(packed.A_sign)
    if packed.has_plog:
        kf_p = jnp.exp(_plog_logkf(packed, T, logT, pres))
        kf = kf.at[..., i(packed.plog_idx)].set(kf_p)
    if packed.has_cheb:
        kf_c = jnp.exp(LOG10 * _cheb_log10kf(packed, T, pres))
        kf = kf.at[..., i(packed.cheb_idx)].set(kf_c)
    return kf


def eval_kc(packed, T):
    """Equilibrium constants in concentration units for all reactions.

    Kc = (PA / (RU T))^sum_nu * exp(sum_k nu_net[k] * smh_k)
    (reference: rate_subs.py:660-809; coefficient grouping done at pack
    time instead of in emitted text).
    """
    logT = jnp.log(T)
    smh = eval_smh(packed, T)                                   # (..., N)
    expo = jnp.einsum('...n,rn->...r', smh, f(packed.nu_net))
    expo = expo + f(packed.sum_nu) * (_LN_PA_RU - logT)[..., None]
    return jnp.exp(expo)


# --------------------------------------------------------------------------
# concentration powers
# --------------------------------------------------------------------------

def _conc_power_product(packed, conc, sp_idx, nu):
    """prod_s C[sp]^nu over padded stoichiometric slots, (..., R)."""
    cg = conc[..., sp_idx]                        # (..., R, S) static gather
    nu = f(nu)
    if packed.has_frac_nu:
        term = jnp.where(nu == 0.0, 1.0, jnp.power(cg, nu))
    else:
        # unrolled integer powers (reference: rate_subs.py:641-648)
        term = jnp.where(nu == 0.0, 1.0, cg)
        acc = cg
        for k in range(2, packed.max_nu_int + 1):
            acc = acc * cg
            term = jnp.where(nu >= float(k), acc, term)
    return jnp.prod(term, axis=-1)


def eval_rxn_rates(packed, T, pres, conc):
    """Forward and reverse rates of progress, each (..., R) [kmol/m^3/s].

    Reverse entries are zero for irreversible reactions (the reference
    compacts them; :func:`compact_rev` recovers that layout).
    Reference: rate_subs.py:254-877.
    """
    kf = eval_kf(packed, T, pres)
    fwd = kf * _conc_power_product(packed, conc, i(packed.reac_sp),
                                   packed.reac_nu)
    if packed.has_rev:
        kc = eval_kc(packed, T)
        kr = kf / kc
        rev = kr * _conc_power_product(packed, conc, i(packed.prod_sp),
                                       packed.prod_nu)
        rev = jnp.where(jnp.asarray(packed.rev_mask), rev, 0.0)
    else:
        rev = jnp.zeros_like(fwd)
    return fwd, rev


# --------------------------------------------------------------------------
# pressure modification
# --------------------------------------------------------------------------

def third_body_concentrations(packed, T, pres, conc):
    """Effective third-body concentration m + sum (alpha-1) C per reaction,
    (..., R) (reference: rate_subs.py:1120-1148)."""
    m = pres / (RU * T)
    return m[..., None] + jnp.einsum('...n,rn->...r', conc, f(packed.eff_m1))


def _troe_F(packed, T, Pr):
    """Troe falloff blending factor (reference: rate_subs.py:1187-1227)."""
    mask = jnp.asarray(packed.troe_mask)
    a = f(packed.troe_par[:, 0])
    # sanitise dead lanes so no inf/NaN leaks into AD tangents
    T3 = jnp.where(mask, f(packed.troe_par[:, 1]), 1.0)
    T1 = jnp.where(mask, f(packed.troe_par[:, 2]), 1.0)
    T2 = f(packed.troe_par[:, 3])
    Tb = T[..., None]
    Fcent = (1.0 - a) * jnp.exp(-Tb / T3) + a * jnp.exp(-Tb / T1)
    if packed.troe_has_T2.any():
        has2 = jnp.asarray(packed.troe_has_T2)
        Fcent = Fcent + jnp.where(has2, jnp.exp(-T2 / Tb), 0.0)
    logFc = safe_log10(Fcent)
    logPr = safe_log10(Pr)
    A = logPr - 0.67 * logFc - 0.4
    B = 0.806 - 1.1762 * logFc - 0.14 * logPr
    return jnp.exp(LOG10 * (logFc / (1.0 + (A / B) ** 2)))


def _sri_F(packed, T, Pr):
    """SRI falloff blending factor (reference: rate_subs.py:1229-1256)."""
    mask = jnp.asarray(packed.sri_mask)
    a = f(packed.sri_par[:, 0])
    b = f(packed.sri_par[:, 1])
    c = jnp.where(mask, f(packed.sri_par[:, 2]), 1.0)
    d = f(packed.sri_par[:, 3])
    e = f(packed.sri_par[:, 4])
    Tb = T[..., None]
    logPr = safe_log10(Pr)
    X = 1.0 / (1.0 + logPr * logPr)
    base = a * jnp.exp(-b / Tb) + jnp.exp(-Tb / c)
    F = jnp.power(jnp.maximum(base, 0.0), X)
    return F * d * jnp.power(Tb, e)


def get_rxn_pres_mod(packed, T, pres, conc):
    """Pressure-modification factors for all reactions, (..., R).

    Rows without third-body/falloff behaviour get exactly 1.0, so
    ``pm * (fwd - rev)`` is the universal rate of progress.
    Reference: rate_subs.py:879-1290.
    """
    R = packed.n_reactions
    ones = jnp.ones(conc.shape[:-1] + (R,), dtype=conc.dtype)
    if not packed.has_pres_mod:
        return ones

    logT = jnp.log(T)
    thd = third_body_concentrations(packed, T, pres, conc)
    pm = ones

    if packed.has_thd_only:
        pm = jnp.where(jnp.asarray(packed.thd_only_mask), thd, pm)

    if packed.has_falloff or packed.has_chemact:
        fall = jnp.asarray(packed.falloff_mask)
        chem = jnp.asarray(packed.chemact_mask)
        pdep = fall | chem
        kf_main = _arrhenius(f(packed.logA), f(packed.beta), f(packed.Ta),
                             T, logT)
        k0 = jnp.where(
            fall,
            _arrhenius(f(packed.low_logA), f(packed.low_beta),
                       f(packed.low_Ta), T, logT),
            kf_main)
        kinf = jnp.where(
            chem,
            _arrhenius(f(packed.high_logA), f(packed.high_beta),
                       f(packed.high_Ta), T, logT),
            kf_main)
        if packed.has_specific_pdep_sp:
            sp_idx = i(jnp.maximum(packed.pdep_sp_idx, 0))
            c_sp = conc[..., sp_idx]
            X = jnp.where(jnp.asarray(packed.pdep_sp_idx) >= 0, c_sp, thd)
        else:
            X = thd
        Pr = k0 * X / kinf

        F = jnp.ones_like(Pr)
        if packed.has_troe:
            F = jnp.where(jnp.asarray(packed.troe_mask),
                          _troe_F(packed, T, Pr), F)
        if packed.has_sri:
            F = jnp.where(jnp.asarray(packed.sri_mask),
                          _sri_F(packed, T, Pr), F)

        blend = jnp.where(fall, Pr / (1.0 + Pr), 1.0 / (1.0 + Pr))
        pm = jnp.where(pdep, F * blend, pm)

    return pm


# --------------------------------------------------------------------------
# species production rates
# --------------------------------------------------------------------------

def eval_spec_rates(packed, fwd, rev, pres_mod):
    """Net molar production rate per species, (..., N) [kmol/m^3/s].

    omega = nu_net^T (pres_mod * (fwd - rev)) as a dense batched matmul
    (reference: rate_subs.py:1297-1527 emits this as signed scalar sums).
    """
    q = pres_mod * (fwd - rev)
    return jnp.einsum('...r,rn->...n', q, f(packed.nu_net))


def rates_of_progress(packed, T, pres, conc):
    """Convenience: (fwd, rev, pres_mod, net q) in one call."""
    fwd, rev = eval_rxn_rates(packed, T, pres, conc)
    pm = get_rxn_pres_mod(packed, T, pres, conc)
    return fwd, rev, pm, pm * (fwd - rev)


# --------------------------------------------------------------------------
# layout helpers for reference parity
# --------------------------------------------------------------------------

def compact_rev(packed, rev):
    """Gather reverse rates into the reference's compacted layout
    (only reversible reactions, reference: rate_subs.py:811-813)."""
    return rev[..., i(packed.rev_map)]


def compact_pres_mod(packed, pres_mod):
    """Gather pres_mod into the reference's compacted layout
    (only third-body/falloff reactions)."""
    return pres_mod[..., i(packed.pres_mod_map)]


# --------------------------------------------------------------------------
# log-space evaluation (f32-exponent-range safe)
# --------------------------------------------------------------------------

# concentration floor for log-space products: keeps ln C finite at
# zero concentrations while leaving rates (error O(floor)) and their
# AD derivatives asymptotically correct — d exp(nu ln C)/dC at the
# floor equals nu C^(nu-1) * (others), the true sensitivity
_LOG_FLOOR = 1e-25


def log_kf(packed, T, pres):
    """(ln|kf|, sign) without exponentiating, so extreme rate constants
    never form as linear-space intermediates (the log-space dydt used by
    ``jacobian_fwd(log_space=True)``). Reference math:
    rate_subs.py:27-146."""
    logT = jnp.log(T)
    lnkf = (f(packed.logA) + f(packed.beta) * logT[..., None] -
            f(packed.Ta) / T[..., None])
    if packed.has_plog:
        lnkf = lnkf.at[..., i(packed.plog_idx)].set(
            _plog_logkf(packed, T, logT, pres))
    if packed.has_cheb:
        lnkf = lnkf.at[..., i(packed.cheb_idx)].set(
            LOG10 * _cheb_log10kf(packed, T, pres))
    if packed.has_negative_A:
        # PLOG/Chebyshev rows just had lnkf overwritten wholesale, so
        # any sign from a zero/negative placeholder Arrhenius line must
        # not survive — mirror eval_kf's ordering (sign applied BEFORE
        # the overwrite) by neutralising it on overwritten rows
        sign = f(packed.A_sign)
        if packed.has_plog:
            sign = sign.at[i(packed.plog_idx)].set(1.0)
        if packed.has_cheb:
            sign = sign.at[i(packed.cheb_idx)].set(1.0)
    else:
        sign = None
    return lnkf, sign


def _log_conc_dot(packed, lnc, sp_idx, nu):
    """sum_s nu_s ln C[sp_s] over stoichiometric slots, (..., R)."""
    return jnp.sum(f(nu) * lnc[..., sp_idx], axis=-1)


def eval_rxn_rates_log(packed, T, pres, conc):
    """Forward/reverse rates of progress via single exponentiation of
    ln kf + sum nu ln C (- ln Kc): every intermediate stays within the
    f32 exponent range (reference math: rate_subs.py:660-809 for Kc)."""
    lnc = jnp.log(jnp.maximum(conc, _LOG_FLOOR))
    lnkf, sign = log_kf(packed, T, pres)
    fwd = jnp.exp(lnkf + _log_conc_dot(packed, lnc, i(packed.reac_sp),
                                       packed.reac_nu))
    if sign is not None:
        fwd = fwd * sign
    if packed.has_rev:
        logT = jnp.log(T)
        smh = eval_smh(packed, T)
        ln_kc = (jnp.einsum('...n,rn->...r', smh, f(packed.nu_net)) +
                 f(packed.sum_nu) * (_LN_PA_RU - logT)[..., None])
        rev = jnp.exp(lnkf - ln_kc +
                      _log_conc_dot(packed, lnc, i(packed.prod_sp),
                                    packed.prod_nu))
        if sign is not None:
            rev = rev * sign
        rev = jnp.where(jnp.asarray(packed.rev_mask), rev, 0.0)
    else:
        rev = jnp.zeros_like(fwd)
    return fwd, rev


def get_rxn_pres_mod_log(packed, T, pres, conc):
    """Pressure modification with the falloff ratio in log space:
    Pr = exp(ln k0 - ln kinf + ln X) and the Lindemann blend as a
    sigmoid of ln Pr (stable at any Pr magnitude)."""
    R = packed.n_reactions
    ones = jnp.ones(conc.shape[:-1] + (R,), dtype=conc.dtype)
    if not packed.has_pres_mod:
        return ones

    logT = jnp.log(T)
    thd = third_body_concentrations(packed, T, pres, conc)
    pm = ones
    if packed.has_thd_only:
        pm = jnp.where(jnp.asarray(packed.thd_only_mask), thd, pm)

    if packed.has_falloff or packed.has_chemact:
        fall = jnp.asarray(packed.falloff_mask)
        chem = jnp.asarray(packed.chemact_mask)
        pdep = fall | chem
        ln_main = (f(packed.logA) + f(packed.beta) * logT[..., None] -
                   f(packed.Ta) / T[..., None])
        ln_k0 = jnp.where(
            fall, f(packed.low_logA) + f(packed.low_beta) *
            logT[..., None] - f(packed.low_Ta) / T[..., None], ln_main)
        ln_kinf = jnp.where(
            chem, f(packed.high_logA) + f(packed.high_beta) *
            logT[..., None] - f(packed.high_Ta) / T[..., None], ln_main)
        if packed.has_specific_pdep_sp:
            sp_idx = i(jnp.maximum(packed.pdep_sp_idx, 0))
            c_sp = conc[..., sp_idx]
            X = jnp.where(jnp.asarray(packed.pdep_sp_idx) >= 0, c_sp, thd)
        else:
            X = thd
        ln_pr = ln_k0 - ln_kinf + jnp.log(jnp.maximum(X, _LOG_FLOOR))
        # F factors are functions of log10 Pr: a clipped linear-space
        # Pr is exact inside |ln Pr| < 60 and F -> its asymptote beyond
        Pr_c = jnp.exp(jnp.clip(ln_pr, -60.0, 60.0))
        F = jnp.ones_like(Pr_c)
        if packed.has_troe:
            F = jnp.where(jnp.asarray(packed.troe_mask),
                          _troe_F(packed, T, Pr_c), F)
        if packed.has_sri:
            F = jnp.where(jnp.asarray(packed.sri_mask),
                          _sri_F(packed, T, Pr_c), F)
        import jax
        blend = jnp.where(fall, jax.nn.sigmoid(ln_pr),
                          jax.nn.sigmoid(-ln_pr))
        pm = jnp.where(pdep, F * blend, pm)
    return pm
