"""Closed-form analytical Jacobian d(dy/dt)/dy, batched over states.

Re-derivation of the reference's generated ``jacob`` source
(reference: pyjac/core/create_jacobian.py:2189-3277 ``write_jacobian``;
dT terms :1135-1851, species terms :127-489, finishing passes
:3109-3254 and :1853-1905).

Mathematical structure (rather than pyJac's per-entry text emission):

* every reaction's rate of progress ``q = pm (Rf - Rr)`` is
  differentiated once w.r.t. temperature and once w.r.t. each species
  concentration; the concentration dependence of the state maps back to
  mass fractions through

      dC_m/dY_j = C_m r_j + (rho/W_j) d_mj - (rho/W_N) d_mN

  which is *diagonal + two rank-one terms*.  Exploiting Euler's theorem
  (sum_m nu_m C_m dR/dC_m = ord R), the whole species block becomes

      domega/dY = nu_net^T @ P1  +  (nu_net^T c_u) u^T + (nu_net^T c_1) 1^T

  one dense batched matmul plus two outer products, instead
  of the reference's O(R N^2) emitted statements.
* temperature and pressure-dependence enter through per-reaction scalar
  log-derivatives (Arrhenius, PLOG interval weights, Chebyshev
  derivative polynomials, Troe/SRI blending factors), each O(R).

The result is laid out like the reference's: ``J[..., i, j] =
d f_i / d y_j`` with ``y = [T, Y_1..Y_{N-1}]`` and ``f = dy/dt``;
row/column 0 is the temperature equation.

``jacobian_fwd`` (forward-mode AD of dydt) is this module's built-in
oracle — the analog of the reference's Adept autodiff check
(reference: pyjac/core/mech_auxiliary.py:56-79).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.constants import RU
from .common import LOG10, TINY, f, i
from .dydt import dydt as dydt_dispatch
from .rates import _arrhenius, _cheb_pows
from .thermo import (eval_cp, eval_cv, eval_dcp_dT, eval_dsmh_dT, eval_h,
                     eval_smh, eval_u)

_LN_PA_RU = math.log(101325.0 / RU)


# ---------------------------------------------------------------------------
# forward rate constant with log-derivatives
# ---------------------------------------------------------------------------

def _kf_with_derivs(packed, T, logT, pres):
    """(kf, dln kf/dT |_P, dln kf/dln P), each (..., R)."""
    Tb = T[..., None]
    kf = _arrhenius(f(packed.logA), f(packed.beta), f(packed.Ta), T, logT)
    if packed.has_negative_A:
        kf = kf * f(packed.A_sign)
    dlnkf_dT = (f(packed.beta) + f(packed.Ta) / Tb) / Tb
    aP = jnp.zeros_like(kf)

    if packed.has_plog:
        tab = f(packed.plog_lnP)
        n = i(packed.plog_n)
        lnP = jnp.log(pres)
        cnt = jnp.sum(lnP[..., None, None] > tab, axis=-1)
        idx_lo = jnp.clip(cnt - 1, 0, jnp.maximum(n - 2, 0))
        idx_hi = jnp.minimum(idx_lo + 1, n - 1)

        lnk = (f(packed.plog_logA) +
               f(packed.plog_beta) * logT[..., None, None] -
               f(packed.plog_Ta) / T[..., None, None])
        dlnk = (f(packed.plog_beta) + f(packed.plog_Ta) /
                T[..., None, None]) / T[..., None, None]

        def take(arr, idx):
            return jnp.take_along_axis(
                jnp.broadcast_to(arr, lnk.shape), idx[..., None],
                axis=-1)[..., 0]

        lo, hi = take(lnk, idx_lo), take(lnk, idx_hi)
        dlo, dhi = take(dlnk, idx_lo), take(dlnk, idx_hi)
        P_lo, P_hi = take(tab, idx_lo), take(tab, idx_hi)
        denom = P_hi - P_lo
        safe = jnp.where(denom == 0.0, 1.0, denom)
        w_raw = (lnP[..., None] - P_lo) / safe
        w = jnp.clip(w_raw, 0.0, 1.0)
        interior = (w_raw > 0.0) & (w_raw < 1.0) & (denom != 0.0)

        logkf_p = lo + (hi - lo) * w
        dlnkf_p = dlo + (dhi - dlo) * w
        aP_p = jnp.where(interior, (hi - lo) / safe, 0.0)

        pidx = i(packed.plog_idx)
        kf = kf.at[..., pidx].set(jnp.exp(logkf_p))
        dlnkf_dT = dlnkf_dT.at[..., pidx].set(dlnkf_p)
        aP = aP.at[..., pidx].set(aP_p)

    if packed.has_cheb:
        tl = f(packed.cheb_tlim)
        pl = f(packed.cheb_plim)
        Tred = ((2.0 / T)[..., None] - tl[:, 0]) / tl[:, 1]
        Pred = (2.0 * jnp.log10(jnp.maximum(pres, TINY))[..., None] -
                pl[:, 0]) / pl[:, 1]
        coef = f(packed.cheb_coef)
        NT, NP = coef.shape[1], coef.shape[2]
        Tp, dTp = _cheb_pows_with_derivs(Tred, NT)
        Pp, dPp = _cheb_pows_with_derivs(Pred, NP)
        log10k = jnp.einsum('...ri,rij,...rj->...r', Tp, coef, Pp)
        dlog10k_dTred = jnp.einsum('...ri,rij,...rj->...r', dTp, coef, Pp)
        dlog10k_dPred = jnp.einsum('...ri,rij,...rj->...r', Tp, coef, dPp)
        dTred_dT = (-2.0 / (T * T))[..., None] / tl[:, 1]
        # Pred depends on log10 P: dPred/dlnP = 2 / (ln 10 * psub)
        dPred_dlnP = 2.0 / (LOG10 * pl[:, 1])

        cidx = i(packed.cheb_idx)
        kf = kf.at[..., cidx].set(jnp.exp(LOG10 * log10k))
        dlnkf_dT = dlnkf_dT.at[..., cidx].set(
            LOG10 * dlog10k_dTred * dTred_dT)
        aP = aP.at[..., cidx].set(LOG10 * dlog10k_dPred * dPred_dlnP)

    return kf, dlnkf_dT, aP


def _cheb_pows_with_derivs(x, n: int):
    """(T_0..T_{n-1}(x), T'_0..T'_{n-1}(x)) stacked on a trailing axis."""
    polys = [jnp.ones_like(x)]
    derivs = [jnp.zeros_like(x)]
    if n > 1:
        polys.append(x)
        derivs.append(jnp.ones_like(x))
    for _ in range(2, n):
        derivs.append(2.0 * polys[-1] + 2.0 * x * derivs[-1] - derivs[-2])
        polys.append(2.0 * x * polys[-1] - polys[-2])
    return jnp.stack(polys, axis=-1), jnp.stack(derivs, axis=-1)


# ---------------------------------------------------------------------------
# concentration-power products with slot derivatives
# ---------------------------------------------------------------------------

def _pow_static(c, nu, max_int: int, has_frac: bool):
    """c ** nu with nu a constant array of small coefficients."""
    if has_frac:
        return jnp.where(nu == 0.0, 1.0, jnp.power(c, nu))
    out = jnp.where(nu == 0.0, 1.0, c)
    acc = c
    for k in range(2, max_int + 1):
        acc = acc * c
        out = jnp.where(nu >= float(k), acc, out)
    return out


def _product_and_slot_derivs(packed, conc, sp_idx, nu):
    """(prod_s C^nu, d(prod)/dC_s per slot) — (..., R) and (..., R, S).

    Uses exclusive prefix/suffix products over the (small, static) slot
    axis so zero concentrations never hit a division
    (the reference emits the product-without-C_j explicitly,
    create_jacobian.py:127-269).
    """
    nu = f(nu)
    cg = conc[..., sp_idx]                           # (..., R, S)
    powers = _pow_static(cg, nu, packed.max_nu_int, packed.has_frac_nu)
    total = jnp.prod(powers, axis=-1)

    S = powers.shape[-1]
    ones = jnp.ones_like(powers[..., :1])
    # exclusive products around each slot
    if S == 1:
        excl = ones
    else:
        prefix = jnp.concatenate(
            [ones, jnp.cumprod(powers[..., :-1], axis=-1)], axis=-1)
        suffix = jnp.concatenate(
            [jnp.cumprod(powers[..., :0:-1], axis=-1)[..., ::-1], ones],
            axis=-1)
        excl = prefix * suffix
    # d(C^nu)/dC = nu * C^(nu-1)
    dpow = f(nu) * _pow_static(cg, jnp.maximum(nu - 1.0, 0.0),
                               max(packed.max_nu_int - 1, 1),
                               packed.has_frac_nu)
    if packed.has_frac_nu:
        # fractional nu - 1 may be negative: evaluate directly
        dpow = jnp.where(nu == 0.0, 0.0,
                         nu * jnp.power(cg, nu - 1.0))
    else:
        dpow = jnp.where(nu == 0.0, 0.0, dpow)
    return total, dpow * excl


def _scatter_slots(vals, sp_idx, R: int, N: int):
    """Accumulate (..., R, S) slot values into a dense (..., R, N)
    matrix via static one-hot masks.

    The static-index scatter is written as sum_s vals[..., s, None] *
    onehot_s: S broadcast multiply-adds against constant (R, N) masks,
    which XLA fuses into one elementwise pass that writes the dense
    output (no scatter op is emitted).
    """
    sp_idx = np.asarray(sp_idx)
    S = sp_idx.shape[1]
    lead = vals.shape[:-2]
    out = None
    rows = np.arange(R)
    for s in range(S):
        onehot = np.zeros((R, N), dtype=np.float64)
        onehot[rows, sp_idx[:, s]] = 1.0
        term = vals[..., s, None] * f(onehot)
        out = term if out is None else out + term
    if out is None:
        out = jnp.zeros(lead + (R, N), dtype=vals.dtype)
    return out


# ---------------------------------------------------------------------------
# the Jacobian
# ---------------------------------------------------------------------------

def eval_jacobian(packed, t, param, y, conp: bool = True,
                  return_dydt: bool = False):
    """Analytical Jacobian J[..., i, j] = d f_i / d y_j, shape (..., N, N).

    ``param`` is pressure [Pa] (conp=True) or density [kg/m^3]
    (conp=False); ``y = [T, Y_1..Y_{N-1}]``.  With ``return_dydt`` the
    state derivative (computed anyway) is returned alongside.
    """
    N = packed.n_species
    R = packed.n_reactions
    T = y[..., 0]
    Y = y[..., 1:]
    logT = jnp.log(T)
    inv_mw = f(packed.inv_mw)
    mw = f(packed.mw)

    # --- state, concentrations, regime scalars -----------------------------
    y_N = 1.0 - jnp.sum(Y, axis=-1)
    mw_avg = 1.0 / (jnp.sum(Y * inv_mw[:-1], axis=-1) + y_N * inv_mw[-1])
    if conp:
        pres = jnp.broadcast_to(jnp.asarray(param, dtype=y.dtype), T.shape)
        rho = pres * mw_avg / (RU * T)
        dlnrho_dT = -1.0 / T
        dlnP_dT = jnp.zeros_like(T)
    else:
        rho = jnp.broadcast_to(jnp.asarray(param, dtype=y.dtype), T.shape)
        pres = rho * RU * T / mw_avg
        dlnrho_dT = jnp.zeros_like(T)
        dlnP_dT = 1.0 / T
    y_full = jnp.concatenate([Y, y_N[..., None]], axis=-1)
    conc = rho[..., None] * y_full * inv_mw

    # static reduced-species vectors
    u_vec = f(packed.inv_mw[:-1] - packed.inv_mw[-1])          # (N-1,)
    if conp:
        r_vec = -mw_avg[..., None] * u_vec                     # dln rho/dY_j
        pi_vec = jnp.zeros_like(r_vec)                         # dln P/dY_j
    else:
        r_vec = jnp.zeros(T.shape + (N - 1,), dtype=y.dtype)
        pi_vec = mw_avg[..., None] * u_vec

    # --- forward/reverse rate constants and their log-derivatives ----------
    kf, dlnkf_dT, aP = _kf_with_derivs(packed, T, logT, pres)
    nu_net = f(packed.nu_net)                                   # (R, N)
    if packed.has_rev:
        smh = eval_smh(packed, T)
        lnKc = (jnp.einsum('...n,rn->...r', smh, nu_net) +
                f(packed.sum_nu) * (_LN_PA_RU - logT)[..., None])
        kr = jnp.where(jnp.asarray(packed.rev_mask),
                       kf * jnp.exp(-lnKc), 0.0)
        dlnKc_dT = (jnp.einsum('...n,rn->...r',
                               eval_dsmh_dT(packed, T), nu_net) -
                    f(packed.sum_nu) / T[..., None])
        dlnkr_dT = dlnkf_dT - dlnKc_dT
    else:
        kr = jnp.zeros_like(kf)
        dlnkr_dT = jnp.zeros_like(kf)

    # --- rates of progress and concentration (slot) derivatives ------------
    pf, dpf = _product_and_slot_derivs(packed, conc, i(packed.reac_sp),
                                       packed.reac_nu)
    pr_, dpr = _product_and_slot_derivs(packed, conc, i(packed.prod_sp),
                                        packed.prod_nu)
    Rf = kf * pf
    Rr = kr * pr_
    ordf = f(packed.reac_nu.sum(axis=1))                        # (R,)
    ordr = f(packed.prod_nu.sum(axis=1))

    # D[b, r, m] = d(Rf - Rr)/dC_m
    D = (_scatter_slots(kf[..., None] * dpf, packed.reac_sp, R, N) -
         _scatter_slots(kr[..., None] * dpr, packed.prod_sp, R, N))

    # --- pressure modification and its derivatives --------------------------
    pm = jnp.ones_like(kf)
    dpm_dT = jnp.zeros_like(kf)       # total d pm/dT (incl. conc(T) chain)
    # rank-one coefficient on u_vec and on the all-ones vector, plus dense
    # coefficients multiplying the static alpha_tilde / pd_tilde matrices
    c_u_pm = jnp.zeros_like(kf)       # coefficient on u_j from pm
    psi = jnp.zeros_like(kf)          # coefficient on alpha_tilde[r, j]
    xi = jnp.zeros_like(kf)           # coefficient on pd_tilde[r, j]

    if packed.has_pres_mod:
        m_tb = pres / (RU * T)
        thd = m_tb[..., None] + jnp.einsum('...n,rn->...r', conc,
                                           f(packed.eff_m1))
        qnet_pm = Rf - Rr             # net rate before pm

        if packed.has_thd_only:
            msk = jnp.asarray(packed.thd_only_mask)
            pm = jnp.where(msk, thd, pm)
            if conp:
                dpm_dT = jnp.where(msk, -thd / T[..., None], dpm_dT)
            # dthd/dY_j = r_j (thd - m) [conp] + rho u_j [conv] + rho at~
            if conp:
                c_u_pm = jnp.where(
                    msk, -mw_avg[..., None] * (thd - m_tb[..., None]),
                    c_u_pm)
            else:
                c_u_pm = jnp.where(msk, rho[..., None], c_u_pm)
            psi = jnp.where(msk, rho[..., None], psi)

        if packed.has_falloff or packed.has_chemact:
            fall = jnp.asarray(packed.falloff_mask)
            chem = jnp.asarray(packed.chemact_mask)
            pdep = fall | chem
            kf_main = _arrhenius(f(packed.logA), f(packed.beta),
                                 f(packed.Ta), T, logT)
            dln_main = (f(packed.beta) + f(packed.Ta) / T[..., None]) / \
                T[..., None]
            k0 = jnp.where(fall, _arrhenius(f(packed.low_logA),
                                            f(packed.low_beta),
                                            f(packed.low_Ta), T, logT),
                           kf_main)
            dlnk0_dT = jnp.where(
                fall, (f(packed.low_beta) + f(packed.low_Ta) /
                       T[..., None]) / T[..., None], dln_main)
            kinf = jnp.where(chem, _arrhenius(f(packed.high_logA),
                                              f(packed.high_beta),
                                              f(packed.high_Ta), T, logT),
                             kf_main)
            dlnkinf_dT = jnp.where(
                chem, (f(packed.high_beta) + f(packed.high_Ta) /
                       T[..., None]) / T[..., None], dln_main)

            spec_mask = jnp.asarray(packed.pdep_sp_idx) >= 0
            if packed.has_specific_pdep_sp:
                sp_idx = i(np.maximum(packed.pdep_sp_idx, 0))
                X = jnp.where(spec_mask, conc[..., sp_idx], thd)
            else:
                X = thd
            ratio = k0 / kinf
            Pr = ratio * X

            # --- blending factor F and derivatives --------------------------
            F = jnp.ones_like(Pr)
            dF_dT = jnp.zeros_like(Pr)     # explicit T dependence only
            dF_dL = jnp.zeros_like(Pr)     # L = log10(max(Pr, tiny))
            L = jnp.log10(jnp.maximum(Pr, TINY))
            dL_dPr = jnp.where(Pr > TINY, 1.0 / (LOG10 *
                                                 jnp.maximum(Pr, TINY)),
                               0.0)

            if packed.has_troe:
                tmask = jnp.asarray(packed.troe_mask)
                a = f(packed.troe_par[:, 0])
                T3 = jnp.where(tmask, f(packed.troe_par[:, 1]), 1.0)
                T1 = jnp.where(tmask, f(packed.troe_par[:, 2]), 1.0)
                T2 = f(packed.troe_par[:, 3])
                Tb = T[..., None]
                e3 = jnp.exp(-Tb / T3)
                e1 = jnp.exp(-Tb / T1)
                Fcent = (1.0 - a) * e3 + a * e1
                dFc_dT = -(1.0 - a) / T3 * e3 - a / T1 * e1
                if packed.troe_has_T2.any():
                    has2 = jnp.asarray(packed.troe_has_T2)
                    e2 = jnp.exp(-T2 / Tb)
                    Fcent = Fcent + jnp.where(has2, e2, 0.0)
                    dFc_dT = dFc_dT + jnp.where(
                        has2, T2 / (Tb * Tb) * e2, 0.0)
                c = jnp.log10(jnp.maximum(Fcent, TINY))
                dc_dT = jnp.where(Fcent > TINY,
                                  dFc_dT / (LOG10 * jnp.maximum(Fcent,
                                                                TINY)),
                                  0.0)
                A_ = L - 0.67 * c - 0.4
                B_ = 0.806 - 1.1762 * c - 0.14 * L
                AB = A_ / B_
                g = 1.0 / (1.0 + AB * AB)
                Ft = jnp.exp(LOG10 * c * g)
                # dg/dc and dg/dL
                dg_dc = -g * g * 2.0 * AB * ((-0.67) * B_ -
                                             A_ * (-1.1762)) / (B_ * B_)
                dg_dL = -g * g * 2.0 * AB * (B_ - A_ * (-0.14)) / (B_ * B_)
                dFt_dT = Ft * LOG10 * (g + c * dg_dc) * dc_dT
                dFt_dL = Ft * LOG10 * c * dg_dL
                F = jnp.where(tmask, Ft, F)
                dF_dT = jnp.where(tmask, dFt_dT, dF_dT)
                dF_dL = jnp.where(tmask, dFt_dL, dF_dL)

            if packed.has_sri:
                smask = jnp.asarray(packed.sri_mask)
                a_s = f(packed.sri_par[:, 0])
                b_s = f(packed.sri_par[:, 1])
                c_s = jnp.where(smask, f(packed.sri_par[:, 2]), 1.0)
                d_s = f(packed.sri_par[:, 3])
                e_s = f(packed.sri_par[:, 4])
                Tb = T[..., None]
                eb = jnp.exp(-b_s / Tb)
                ec = jnp.exp(-Tb / c_s)
                base = jnp.maximum(a_s * eb + ec, TINY)
                Xs = 1.0 / (1.0 + L * L)
                Fs = jnp.power(base, Xs) * d_s * jnp.power(Tb, e_s)
                dbase_dT = a_s * b_s / (Tb * Tb) * eb - ec / c_s
                dFs_dT = Fs * (Xs * dbase_dT / base + e_s / Tb)
                dXs_dL = -2.0 * L * Xs * Xs
                dFs_dL = Fs * jnp.log(base) * dXs_dL
                F = jnp.where(smask, Fs, F)
                dF_dT = jnp.where(smask, dFs_dT, dF_dT)
                dF_dL = jnp.where(smask, dFs_dL, dF_dL)

            G = jnp.where(fall, Pr / (1.0 + Pr), 1.0 / (1.0 + Pr))
            dG_dPr = jnp.where(fall, 1.0, -1.0) / ((1.0 + Pr) *
                                                   (1.0 + Pr))
            # d pm/d Pr at fixed T-explicit parts
            Phi = F * dG_dPr + G * dF_dL * dL_dPr

            # --- temperature derivative ------------------------------------
            dlnX_dT = (-1.0 / T[..., None]) if conp else 0.0
            dPr_dT = Pr * (dlnk0_dT - dlnkinf_dT + dlnX_dT)
            pm_pdep = F * G
            dpm_pdep_dT = G * dF_dT + Phi * dPr_dT

            pm = jnp.where(pdep, pm_pdep, pm)
            dpm_dT = jnp.where(pdep, dpm_pdep_dT, dpm_dT)

            # --- mass-fraction derivative ------------------------------------
            # dPr/dY_j = ratio * dX/dY_j
            if conp:
                cu_mix = -mw_avg[..., None] * (thd - m_tb[..., None])
            else:
                cu_mix = jnp.broadcast_to(rho[..., None], thd.shape)
            if packed.has_specific_pdep_sp:
                C_pd = jnp.where(spec_mask, X, 0.0)
                cu_spec = C_pd * (-mw_avg[..., None]) if conp \
                    else jnp.zeros_like(X)
                cu_X = jnp.where(spec_mask, cu_spec, cu_mix)
            else:
                cu_X = cu_mix
            c_u_pm = jnp.where(pdep, Phi * ratio * cu_X, c_u_pm)
            psi = jnp.where(pdep & ~spec_mask, Phi * ratio * rho[..., None],
                            psi)
            if packed.has_specific_pdep_sp:
                xi = jnp.where(pdep & spec_mask,
                               Phi * ratio * rho[..., None], xi)

    # --- assemble dq/dT (..., R) ----------------------------------------------
    qnet = Rf - Rr
    q = pm * qnet
    dq_dT = (pm * (Rf * dlnkf_dT - Rr * dlnkr_dT) +
             pm * dlnrho_dT[..., None] * (ordf * Rf - ordr * Rr) +
             dpm_dT * qnet +
             pm * qnet * aP * dlnP_dT[..., None])

    # --- assemble dq/dY via matmul + rank-one structure -------------------------
    # dense part P1[b, r, j], j over reduced species
    inv_w_red = inv_mw[:-1]
    P1 = pm[..., None] * rho[..., None, None] * D[..., :-1] * inv_w_red
    if packed.has_pres_mod:
        alpha_tilde = f(packed.eff_m1[:, :-1] * packed.inv_mw[None, :-1] -
                        (packed.eff_m1[:, -1] * packed.inv_mw[-1])[:, None])
        P1 = P1 + (psi * qnet)[..., None] * alpha_tilde
        if packed.has_specific_pdep_sp:
            pd = np.asarray(packed.pdep_sp_idx)
            pd_tilde = np.zeros((R, N - 1))
            rows = np.where(pd >= 0)[0]
            for rr in rows:
                if pd[rr] < N - 1:
                    pd_tilde[rr, pd[rr]] += packed.inv_mw[pd[rr]]
                else:
                    pd_tilde[rr, :] -= packed.inv_mw[N - 1]
            P1 = P1 + (xi * qnet)[..., None] * f(pd_tilde)
    # rank-one coefficients (..., R)
    c_u = pm * (ordf * Rf - ordr * Rr) * (-mw_avg[..., None]) if conp \
        else jnp.zeros_like(q)
    c_u = c_u + c_u_pm * qnet
    if not conp:
        # P-dependence of kf under CONV: dln P/dY_j = mw_avg u_j
        c_u = c_u + pm * qnet * aP * mw_avg[..., None]
    c_1 = -pm * rho[..., None] * inv_mw[-1] * D[..., -1]

    # --- contract with stoichiometry (batched matmuls) --------------------------
    domega_dT = jnp.einsum('...r,rn->...n', dq_dT, nu_net)       # (..., N)
    domega_dY = jnp.einsum('...rj,rn->...nj', P1, nu_net)        # (..., N, N-1)
    v_u = jnp.einsum('...r,rn->...n', c_u, nu_net)
    v_1 = jnp.einsum('...r,rn->...n', c_1, nu_net)
    domega_dY = (domega_dY + v_u[..., None] * u_vec +
                 v_1[..., None])
    omega = jnp.einsum('...r,rn->...n', q, nu_net)

    # --- thermodynamic closures ---------------------------------------------------
    if conp:
        cp = eval_cp(packed, T)
        h = eval_h(packed, T)
        spec_heat_avg = jnp.sum(cp * y_full, axis=-1)
        dsh_dT = jnp.sum(eval_dcp_dT(packed, T) * y_full, axis=-1)
        e_spec = h
        de_dT = cp
    else:
        cv = eval_cv(packed, T)
        u_int = eval_u(packed, T)
        spec_heat_avg = jnp.sum(cv * y_full, axis=-1)
        dsh_dT = jnp.sum(eval_dcp_dT(packed, T) * y_full, axis=-1)
        e_spec = u_int
        de_dT = cv

    rho_inv = 1.0 / rho
    fk = omega * mw * rho_inv[..., None]              # (..., N) incl. last
    denomT = rho * spec_heat_avg
    # e_spec*W pre-divided by rho*cp_bar once, so every temperature-row
    # contraction below reuses the scaled weights
    eWn = e_spec * mw / denomT[..., None]
    fT = -jnp.sum(eWn * omega, axis=-1)

    # species rows (reduced)
    JYY = (mw[:-1, None] * rho_inv[..., None, None] *
           domega_dY[..., :-1, :])
    if conp:
        JYY = JYY - fk[..., :-1, None] * r_vec[..., None, :]
    JYT = (mw[:-1] * rho_inv[..., None] * domega_dT[..., :-1] -
           fk[..., :-1] * dlnrho_dT[..., None])

    # temperature row
    JTY = -jnp.einsum('...n,...nj->...j', eWn, domega_dY)
    if conp:
        heat_j = (cp[..., :-1] - cp[..., -1:])
    else:
        heat_j = (cv[..., :-1] - cv[..., -1:])
    JTY = JTY - fT[..., None] * (r_vec + heat_j / spec_heat_avg[..., None])
    JTT = (-(jnp.sum(de_dT * mw * omega / denomT[..., None],
                     axis=-1) +
             jnp.sum(eWn * domega_dT, axis=-1)) -
           fT * (dlnrho_dT + dsh_dT / spec_heat_avg))

    # --- stitch (..., N, N) -----------------------------------------------------
    top = jnp.concatenate([JTT[..., None, None], JTY[..., None, :]],
                          axis=-1)
    bottom = jnp.concatenate([JYT[..., :, None], JYY], axis=-1)
    J = jnp.concatenate([top, bottom], axis=-2)
    if return_dydt:
        f_state = jnp.concatenate([fT[..., None], fk[..., :-1]], axis=-1)
        return J, f_state
    return J


def jacobian_and_dydt(packed, t, param, y, conp: bool = True):
    """(J, dy/dt) in one fused evaluation — dy/dt falls out of the
    Jacobian assembly for free (the reference's eval_jacob likewise
    computes the rates internally, create_jacobian.py:2274-3277)."""
    return eval_jacobian(packed, t, param, y, conp=conp, return_dydt=True)


# ---------------------------------------------------------------------------
# forward-mode AD oracle (the Adept-autodiff analog)
# ---------------------------------------------------------------------------

def jacobian_fwd(packed, t, param, y, conp: bool = True,
                 log_space: bool = False):
    """Jacobian via jax.jacfwd of dydt — exact, used as the correctness
    oracle for :func:`eval_jacobian` (the reference validates its
    emitted Jacobian against Adept autodiff the same way,
    functional_tester/test.py:173-217).

    ``log_space`` differentiates :func:`~pyjac_jax.ops.dydt.dydt_log`
    instead: identical math up to O(1e-25) concentration flooring, with
    rates formed from logarithms (an independent second oracle)."""
    if log_space:
        from .dydt import dydt_log

        def single(yy, pp):
            return dydt_log(packed, t, pp, yy, conp=conp)
    else:
        def single(yy, pp):
            return dydt_dispatch(packed, t, pp, yy, conp=conp)

    jac = jax.jacfwd(single)
    if y.ndim == 1:
        return jac(y, param)
    param_b = jnp.broadcast_to(jnp.asarray(param, dtype=y.dtype),
                               y.shape[:-1])
    flat_y = y.reshape(-1, y.shape[-1])
    flat_p = param_b.reshape(-1)
    out = jax.vmap(jac)(flat_y, flat_p)
    return out.reshape(y.shape[:-1] + out.shape[-2:])


def jacobian_vector_product(packed, t, param, y, v, conp: bool = True):
    """J @ v without forming J — the reference's ``sparse_multiplier``
    analog (create_jacobian.py:3301-3404), exact via jax.jvp."""
    def single(yy):
        return dydt_dispatch(packed, t, param, yy, conp=conp)
    _, jv = jax.jvp(single, (y,), (v,))
    return jv
