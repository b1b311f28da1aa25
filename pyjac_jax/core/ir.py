"""In-memory intermediate representation for chemical mechanisms.

Plain dataclasses mirroring the information content of the reference IR
(reference: pyjac/core/chem_utilities.py:102-254), designed as the input
to :mod:`pyjac_jax.core.pack`, which lowers them to structure-of-arrays
constant tensors for XLA.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

import numpy as np

from .constants import PA

Number = Union[int, float]


@dataclass
class Species:
    """A chemical species with NASA-7 thermodynamic data.

    Reference parity: pyjac/core/chem_utilities.py:219-254.
    """

    name: str
    # elemental composition as (element, count) pairs
    elem: List[Tuple[str, float]] = field(default_factory=list)
    # molecular weight [kg/kmol]
    mw: float = 0.0
    # high-temperature-range NASA-7 coefficients
    hi: np.ndarray = field(default_factory=lambda: np.zeros(7))
    # low-temperature-range NASA-7 coefficients
    lo: np.ndarray = field(default_factory=lambda: np.zeros(7))
    # (T_low, T_mid, T_high) [K]
    Trange: List[float] = field(default_factory=lambda: [300.0, 1000.0, 5000.0])


@dataclass
class Reaction:
    """A single reaction with every auxiliary-card attribute.

    Reference parity: pyjac/core/chem_utilities.py:102-216. Species are
    referred to by name until :func:`pyjac_jax.core.mech.resolve_species`
    rewrites them to integer indices.
    """

    rev: bool
    reac: List[Union[str, int]]
    reac_nu: List[Number]
    prod: List[Union[str, int]]
    prod_nu: List[Number]
    # Arrhenius: pre-exponential A [m, kmol, s], temperature exponent b [-],
    # activation *temperature* E = Ea/R [K]
    A: float
    b: float
    E: float

    # explicit reverse Arrhenius parameters [A, b, E]; the parser splits
    # such reactions into two irreversible ones, so this stays empty in a
    # finalized mechanism (reference: mech_interpret.py:693-713)
    rev_par: List[float] = field(default_factory=list)
    dup: bool = False

    # plain third-body reaction (+M on both sides, no falloff)
    thd_body: bool = False
    # (species, efficiency) pairs
    thd_body_eff: List[Tuple[Union[str, int], float]] = field(default_factory=list)

    # pressure-dependent falloff / chemically-activated reaction
    pdep: bool = False
    # specific third-body species name, or '' for the mixture (+M)
    pdep_sp: Union[str, int, None] = ''
    low: List[float] = field(default_factory=list)
    high: List[float] = field(default_factory=list)

    troe: bool = False
    troe_par: List[float] = field(default_factory=list)

    sri: bool = False
    sri_par: List[float] = field(default_factory=list)

    # Chebyshev pressure dependence
    cheb: bool = False
    cheb_n_temp: int = 0
    cheb_n_pres: int = 0
    cheb_plim: List[float] = field(default_factory=lambda: [0.001 * PA, 100. * PA])
    cheb_tlim: List[float] = field(default_factory=lambda: [300., 2500.])
    cheb_par: Optional[np.ndarray] = None

    # PLOG pressure dependence: list of [pressure [Pa], A, b, E]
    plog: bool = False
    plog_par: Optional[List[List[float]]] = None

    def copy(self) -> "Reaction":
        new = dataclasses.replace(self)
        new.reac = list(self.reac)
        new.reac_nu = list(self.reac_nu)
        new.prod = list(self.prod)
        new.prod_nu = list(self.prod_nu)
        new.rev_par = list(self.rev_par)
        new.thd_body_eff = [list(p) for p in self.thd_body_eff]
        new.low = list(self.low)
        new.high = list(self.high)
        new.troe_par = list(self.troe_par)
        new.sri_par = list(self.sri_par)
        if self.cheb_par is not None:
            new.cheb_par = np.array(self.cheb_par, copy=True)
        new.cheb_plim = list(self.cheb_plim)
        new.cheb_tlim = list(self.cheb_tlim)
        if self.plog_par is not None:
            new.plog_par = [list(p) for p in self.plog_par]
        return new
