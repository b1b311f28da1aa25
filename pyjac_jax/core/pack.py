"""Lower a :class:`~pyjac_jax.core.mech.Mechanism` to packed constant tensors.

This module plays the role of the reference's *code generator*
(reference: pyjac/core/rate_subs.py, pyjac/core/create_jacobian.py):
where pyJac bakes mechanism constants into emitted C/CUDA text, this
rebuild bakes them into structure-of-arrays numpy constants that the
batched JAX kernels in :mod:`pyjac_jax.ops` close over.  XLA then
constant-folds and fuses them per mechanism — the moral equivalent of
pyJac's mechanism-specialised source, minus the text.

Design notes
------------
* Reactions are *category-partitioned* (elementary / third-body /
  falloff / chemically-activated x Lindemann / Troe / SRI, plus PLOG and
  Chebyshev) with boolean masks over the full reaction axis and gathered
  index sets for the rare PLOG/Chebyshev rows.  Static Python booleans
  (``has_troe`` etc.) let kernels drop dead categories at trace time.
* Stoichiometry is kept in two forms: padded per-reaction *slots*
  (species index + coefficient) for the O(slots) concentration-power
  products, and dense ``(R, N)`` matrices for the batched matmul
  assembly of species rates, equilibrium constants, and the Jacobian.
* All constant folding pyJac does textually (log A, activation
  temperatures, Kc coefficient grouping, Chebyshev limit transforms) is
  done here once in float64 numpy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np

from .ir import Reaction
from .mech import Mechanism

_F = np.float64
_I = np.int32


def _is_int(x) -> bool:
    return float(x) == int(x)


@dataclass(frozen=True)
class PackedMechanism:
    """Structure-of-arrays constant representation of a mechanism.

    Shapes use N = n_species, R = n_reactions, Sf/Sp = max reactant /
    product slots, Rp/Rc = number of PLOG / Chebyshev reactions.
    """

    mech: Mechanism

    # --- species -----------------------------------------------------------
    mw: np.ndarray            # (N,) molecular weights [kg/kmol]
    inv_mw: np.ndarray        # (N,)
    a_lo: np.ndarray          # (N, 7) NASA-7 low-T coefficients
    a_hi: np.ndarray          # (N, 7)
    T_mid: np.ndarray         # (N,) polynomial switch temperature

    # --- Arrhenius (forward, all reactions) ---------------------------------
    logA: np.ndarray          # (R,) log|A|
    A_sign: np.ndarray        # (R,) sign(A)
    beta: np.ndarray          # (R,)
    Ta: np.ndarray            # (R,) activation temperature [K]

    # --- stoichiometry -------------------------------------------------------
    reac_sp: np.ndarray       # (R, Sf) int32 species index (0-padded)
    reac_nu: np.ndarray       # (R, Sf) float coefficient (0-padded)
    prod_sp: np.ndarray       # (R, Sp)
    prod_nu: np.ndarray       # (R, Sp)
    nu_fwd: np.ndarray        # (R, N) dense reactant coefficients
    nu_rev: np.ndarray        # (R, N) dense product coefficients
    nu_net: np.ndarray        # (R, N) = nu_rev - nu_fwd
    max_nu_int: int           # largest integer stoichiometric coefficient
    has_frac_nu: bool         # any non-integer coefficient

    # --- reversibility / equilibrium ----------------------------------------
    rev_mask: np.ndarray      # (R,) bool
    sum_nu: np.ndarray        # (R,) net molecule change (for Kc)

    # --- third-body / falloff ------------------------------------------------
    pres_mod_mask: np.ndarray  # (R,) bool: thd_body or pdep
    thd_only_mask: np.ndarray  # (R,) bool: plain third-body
    falloff_mask: np.ndarray   # (R,) bool: pdep with LOW (unimolecular)
    chemact_mask: np.ndarray   # (R,) bool: pdep with HIGH (chem. activated)
    troe_mask: np.ndarray      # (R,) bool
    sri_mask: np.ndarray       # (R,) bool
    eff_m1: np.ndarray         # (R, N) third-body efficiency alpha - 1
    pdep_sp_idx: np.ndarray    # (R,) int32; -1 => mixture concentration
    low_logA: np.ndarray       # (R,)
    low_beta: np.ndarray       # (R,)
    low_Ta: np.ndarray         # (R,)
    high_logA: np.ndarray      # (R,)
    high_beta: np.ndarray      # (R,)
    high_Ta: np.ndarray        # (R,)
    troe_par: np.ndarray       # (R, 4) [a, T3, T1, T2]; T2 = 0 if absent
    troe_has_T2: np.ndarray    # (R,) bool
    sri_par: np.ndarray        # (R, 5) [a, b, c, d, e]; defaults d=1, e=0

    # --- PLOG (gathered subset) ----------------------------------------------
    plog_idx: np.ndarray       # (Rp,) int32 reaction indices
    plog_lnP: np.ndarray       # (Rp, P) padded ln(pressure) breakpoints
    plog_logA: np.ndarray      # (Rp, P)
    plog_beta: np.ndarray      # (Rp, P)
    plog_Ta: np.ndarray        # (Rp, P)
    plog_sign: np.ndarray      # (Rp, P) sign of A
    plog_n: np.ndarray         # (Rp,) number of valid breakpoints

    # --- Chebyshev (gathered subset) ------------------------------------------
    cheb_idx: np.ndarray       # (Rc,) int32 reaction indices
    cheb_coef: np.ndarray      # (Rc, NT, NP) zero-padded coefficients
    cheb_tlim: np.ndarray      # (Rc, 2) precomputed (1/T0+1/T1, 1/T1-1/T0)
    cheb_plim: np.ndarray      # (Rc, 2) precomputed (log10 P0+log10 P1,
                               #          log10 P1-log10 P0)

    # --- bookkeeping -----------------------------------------------------------
    rev_map: np.ndarray        # (n_rev,) indices of reversible reactions
    pres_mod_map: np.ndarray   # (n_pres_mod,) indices of thd/pdep reactions
    seen_sp: np.ndarray        # (N,) bool: species with any net production

    # --- static category flags (trace-time dead-code elimination) -----------
    has_rev: bool = True
    has_pres_mod: bool = False
    has_thd_only: bool = False
    has_falloff: bool = False
    has_chemact: bool = False
    has_troe: bool = False
    has_sri: bool = False
    has_lindemann: bool = False
    has_plog: bool = False
    has_cheb: bool = False
    has_negative_A: bool = False
    has_specific_pdep_sp: bool = False

    @property
    def n_species(self) -> int:
        return int(self.mw.shape[0])

    @property
    def n_reactions(self) -> int:
        return int(self.logA.shape[0])

    @property
    def n_rev(self) -> int:
        return int(self.rev_map.shape[0])

    @property
    def n_pres_mod(self) -> int:
        return int(self.pres_mod_map.shape[0])

    @property
    def species_names(self) -> List[str]:
        return self.mech.species_names


def save_packed(packed: PackedMechanism, path: str) -> None:
    """Persist a packed mechanism (the analog of the reference's cached
    build artifacts, e.g. cache_optimizer's optimized.pickle,
    cache_optimizer.py:456-462)."""
    import pickle
    arrays = {}
    scalars = {}
    for field_ in packed.__dataclass_fields__:
        val = getattr(packed, field_)
        if isinstance(val, np.ndarray):
            arrays[field_] = val
        elif isinstance(val, (bool, int, float)):
            scalars[field_] = val
    np.savez_compressed(
        path,
        __mech__=np.frombuffer(pickle.dumps(packed.mech), dtype=np.uint8),
        __scalars__=np.frombuffer(pickle.dumps(scalars), dtype=np.uint8),
        **arrays)


def load_packed(path: str) -> PackedMechanism:
    """Load a mechanism packed by :func:`save_packed`."""
    import pickle
    with np.load(path, allow_pickle=False) as data:
        mech = pickle.loads(data['__mech__'].tobytes())
        scalars = pickle.loads(data['__scalars__'].tobytes())
        arrays = {k: data[k] for k in data.files
                  if k not in ('__mech__', '__scalars__')}
    return PackedMechanism(mech=mech, **arrays, **scalars)


def pack(mech: Mechanism) -> PackedMechanism:
    """Pack a mechanism into constant tensors (the 'codegen' step)."""
    specs, reacs = mech.specs, mech.reacs
    N, R = len(specs), len(reacs)

    mw = np.array([sp.mw for sp in specs], dtype=_F)
    a_lo = np.stack([np.asarray(sp.lo, dtype=_F) for sp in specs])
    a_hi = np.stack([np.asarray(sp.hi, dtype=_F) for sp in specs])
    T_mid = np.array([sp.Trange[1] for sp in specs], dtype=_F)

    A = np.array([rxn.A for rxn in reacs], dtype=_F)
    # A == 0 (a permanently dead reaction unless PLOG/Chebyshev rows
    # overwrite it) packs as logA = 0 with A_sign = 0: kf multiplies by
    # the sign, making the rate exactly zero with finite derivatives —
    # the reference emits the zero textually (rate_subs.py:27-146)
    logA = np.where(A != 0.0, np.log(np.abs(np.where(A == 0.0, 1.0, A))),
                    0.0)
    A_sign = np.where(A == 0.0, 0.0, np.where(A < 0.0, -1.0, 1.0))
    beta = np.array([rxn.b for rxn in reacs], dtype=_F)
    Ta = np.array([rxn.E for rxn in reacs], dtype=_F)

    # --- stoichiometry ------------------------------------------------------
    Sf = max(max((len(r.reac) for r in reacs), default=1), 1)
    Sp = max(max((len(r.prod) for r in reacs), default=1), 1)
    reac_sp = np.zeros((R, Sf), dtype=_I)
    reac_nu = np.zeros((R, Sf), dtype=_F)
    prod_sp = np.zeros((R, Sp), dtype=_I)
    prod_nu = np.zeros((R, Sp), dtype=_F)
    nu_fwd = np.zeros((R, N), dtype=_F)
    nu_rev = np.zeros((R, N), dtype=_F)
    max_nu = 1
    has_frac = False
    for i, rxn in enumerate(reacs):
        for s, (sp, nu) in enumerate(zip(rxn.reac, rxn.reac_nu)):
            reac_sp[i, s] = sp
            reac_nu[i, s] = nu
            nu_fwd[i, sp] += nu
            if _is_int(nu):
                max_nu = max(max_nu, int(nu))
            else:
                has_frac = True
        for s, (sp, nu) in enumerate(zip(rxn.prod, rxn.prod_nu)):
            prod_sp[i, s] = sp
            prod_nu[i, s] = nu
            nu_rev[i, sp] += nu
            if _is_int(nu):
                max_nu = max(max_nu, int(nu))
            else:
                has_frac = True
    nu_net = nu_rev - nu_fwd
    sum_nu = np.array([sum(r.prod_nu) - sum(r.reac_nu) for r in reacs],
                      dtype=_F)

    rev_mask = np.array([rxn.rev for rxn in reacs], dtype=bool)

    # --- third-body / falloff -------------------------------------------------
    thd_only = np.array([rxn.thd_body for rxn in reacs], dtype=bool)
    pdep = np.array([rxn.pdep for rxn in reacs], dtype=bool)
    falloff = np.array([rxn.pdep and bool(rxn.low) for rxn in reacs],
                       dtype=bool)
    chemact = np.array([rxn.pdep and bool(rxn.high) for rxn in reacs],
                       dtype=bool)
    troe = np.array([rxn.troe for rxn in reacs], dtype=bool)
    sri = np.array([rxn.sri for rxn in reacs], dtype=bool)
    pres_mod = thd_only | pdep

    eff_m1 = np.zeros((R, N), dtype=_F)
    pdep_sp_idx = np.full((R,), -1, dtype=_I)
    low = np.zeros((R, 3), dtype=_F)
    high = np.zeros((R, 3), dtype=_F)
    troe_par = np.zeros((R, 4), dtype=_F)
    troe_has_T2 = np.zeros((R,), dtype=bool)
    sri_par = np.zeros((R, 5), dtype=_F)
    sri_par[:, 3] = 1.0
    for i, rxn in enumerate(reacs):
        for sp, eff in rxn.thd_body_eff:
            eff_m1[i, sp] = eff - 1.0
        if rxn.pdep and rxn.pdep_sp is not None:
            pdep_sp_idx[i] = rxn.pdep_sp
        if rxn.low:
            low[i] = [math.log(rxn.low[0]), rxn.low[1], rxn.low[2]]
        if rxn.high:
            high[i] = [math.log(rxn.high[0]), rxn.high[1], rxn.high[2]]
        if rxn.troe:
            p = list(rxn.troe_par)
            troe_has_T2[i] = len(p) == 4 and p[3] != 0.0
            while len(p) < 4:
                p.append(0.0)
            troe_par[i] = p
        if rxn.sri:
            p = list(rxn.sri_par)
            if len(p) == 3:
                p = p + [1.0, 0.0]
            sri_par[i] = p

    # --- PLOG -----------------------------------------------------------------
    plog_rows = [i for i, r in enumerate(reacs) if r.plog]
    Pmax = max((len(reacs[i].plog_par) for i in plog_rows), default=1)
    Rp = len(plog_rows)
    plog_idx = np.asarray(plog_rows, dtype=_I)
    plog_lnP = np.zeros((Rp, Pmax), dtype=_F)
    plog_logA = np.zeros((Rp, Pmax), dtype=_F)
    plog_beta = np.zeros((Rp, Pmax), dtype=_F)
    plog_Ta = np.zeros((Rp, Pmax), dtype=_F)
    plog_sign = np.ones((Rp, Pmax), dtype=_F)
    plog_n = np.zeros((Rp,), dtype=_I)
    for j, i in enumerate(plog_rows):
        pars = sorted(reacs[i].plog_par, key=lambda p: p[0])
        plog_n[j] = len(pars)
        for k, (P, pA, pb, pE) in enumerate(pars):
            if pA < 0:
                # log-linear interpolation of ln|A| across a sign change
                # has no meaning; the reference cannot represent these
                # either (rate_subs.py:598-632 interpolates log k)
                raise NotImplementedError(
                    'negative pre-exponential factor in PLOG entry of '
                    'reaction %d' % i)
            plog_lnP[j, k] = math.log(P)
            plog_logA[j, k] = math.log(abs(pA))
            plog_sign[j, k] = -1.0 if pA < 0 else 1.0
            plog_beta[j, k] = pb
            plog_Ta[j, k] = pE
        # replicate the final entry into the padding so interval search
        # degenerates gracefully
        for k in range(len(pars), Pmax):
            plog_lnP[j, k] = plog_lnP[j, len(pars) - 1]
            plog_logA[j, k] = plog_logA[j, len(pars) - 1]
            plog_sign[j, k] = plog_sign[j, len(pars) - 1]
            plog_beta[j, k] = plog_beta[j, len(pars) - 1]
            plog_Ta[j, k] = plog_Ta[j, len(pars) - 1]

    # --- Chebyshev --------------------------------------------------------------
    cheb_rows = [i for i, r in enumerate(reacs) if r.cheb]
    Rc = len(cheb_rows)
    NT = max((reacs[i].cheb_n_temp for i in cheb_rows), default=1)
    NP = max((reacs[i].cheb_n_pres for i in cheb_rows), default=1)
    cheb_idx = np.asarray(cheb_rows, dtype=_I)
    cheb_coef = np.zeros((Rc, NT, NP), dtype=_F)
    cheb_tlim = np.zeros((Rc, 2), dtype=_F)
    cheb_plim = np.zeros((Rc, 2), dtype=_F)
    for j, i in enumerate(cheb_rows):
        r = reacs[i]
        cheb_coef[j, :r.cheb_n_temp, :r.cheb_n_pres] = r.cheb_par
        t0, t1 = r.cheb_tlim
        p0, p1 = r.cheb_plim
        cheb_tlim[j] = [1.0 / t0 + 1.0 / t1, 1.0 / t1 - 1.0 / t0]
        cheb_plim[j] = [math.log10(p0) + math.log10(p1),
                        math.log10(p1) - math.log10(p0)]

    rev_map = np.asarray([i for i, r in enumerate(reacs) if r.rev],
                         dtype=_I)
    pres_mod_map = np.asarray([i for i in range(R) if pres_mod[i]],
                              dtype=_I)
    # a species is 'seen' iff some reaction gives it a nonzero net rate
    # (the reference's `seen` from write_spec_rates, rate_subs.py:1322);
    # third-body-only participation does not produce the species
    seen_sp = np.asarray(np.abs(nu_net).sum(axis=0) != 0.0)

    lind = (falloff | chemact) & ~troe & ~sri

    return PackedMechanism(
        mech=mech,
        mw=mw, inv_mw=1.0 / mw, a_lo=a_lo, a_hi=a_hi, T_mid=T_mid,
        logA=logA, A_sign=A_sign, beta=beta, Ta=Ta,
        reac_sp=reac_sp, reac_nu=reac_nu, prod_sp=prod_sp, prod_nu=prod_nu,
        nu_fwd=nu_fwd, nu_rev=nu_rev, nu_net=nu_net,
        max_nu_int=max_nu, has_frac_nu=has_frac,
        rev_mask=rev_mask, sum_nu=sum_nu,
        pres_mod_mask=pres_mod, thd_only_mask=thd_only,
        falloff_mask=falloff, chemact_mask=chemact,
        troe_mask=troe, sri_mask=sri,
        eff_m1=eff_m1, pdep_sp_idx=pdep_sp_idx,
        low_logA=low[:, 0], low_beta=low[:, 1], low_Ta=low[:, 2],
        high_logA=high[:, 0], high_beta=high[:, 1], high_Ta=high[:, 2],
        troe_par=troe_par, troe_has_T2=troe_has_T2, sri_par=sri_par,
        plog_idx=plog_idx, plog_lnP=plog_lnP, plog_logA=plog_logA,
        plog_beta=plog_beta, plog_Ta=plog_Ta, plog_sign=plog_sign,
        plog_n=plog_n,
        cheb_idx=cheb_idx, cheb_coef=cheb_coef, cheb_tlim=cheb_tlim,
        cheb_plim=cheb_plim,
        rev_map=rev_map, pres_mod_map=pres_mod_map, seen_sp=seen_sp,
        has_rev=bool(rev_mask.any()),
        has_pres_mod=bool(pres_mod.any()),
        has_thd_only=bool(thd_only.any()),
        has_falloff=bool(falloff.any()),
        has_chemact=bool(chemact.any()),
        has_troe=bool(troe.any()),
        has_sri=bool(sri.any()),
        has_lindemann=bool(lind.any()),
        has_plog=Rp > 0,
        has_cheb=Rc > 0,
        has_negative_A=bool((A_sign != 1.0).any()),
        has_specific_pdep_sp=bool((pdep_sp_idx >= 0).any()),
    )
