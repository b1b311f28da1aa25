"""Synthetic Chemkin mechanism generator.

Produces mechanisms of arbitrary size that exercise every reaction
category the framework supports (elementary, duplicate, irreversible,
explicit-REV, third-body, Lindemann / Troe / SRI falloff, chemically
activated, PLOG, Chebyshev, non-integer stoichiometry), with plausible
but randomized NASA-7 thermo data.

Used for (a) full-coverage parser/kernel tests beyond the small H2/O2
fixture — whose reactions are only elementary/third-body/Troe — and
(b) size-scaled benchmark mechanisms (e.g. GRI-3.0-sized: 53 species /
325 reactions) when the real mechanism file is not available.
Rates are tuned so states around T in [800, 2500] K neither overflow
nor vanish: intermediates (Kc, kr, Jacobian entries) stay well inside
the float64 range.
"""

from __future__ import annotations

import io
from typing import List, Optional

import numpy as np


def _fmt_nasa_line(vals, count):
    return ''.join('{: .8E}'.format(v) for v in vals[:count])


def _species_thermo(name: str, elems, rng, smh_spread: float = 1.0) -> str:
    """One THERMO entry (4 fixed-column lines) with random-but-sane
    NASA-7 coefficients.

    ``smh_spread`` scales the enthalpy/entropy constants (a5, a6): at
    thousands of reactions the extreme-value tail of sum(nu * smh)
    otherwise produces |ln Kc| ~ 80 — equilibrium constants (and hence
    reverse rates and Jacobian entries ~1e41) far outside anything a
    physical mechanism exhibits.  Drawn-then-scaled so the RNG stream (and every pinned
    fixture mechanism) is unchanged at spread 1."""
    a0 = rng.uniform(2.5, 5.0)
    a1 = rng.uniform(-2e-3, 3e-3)
    a2 = rng.uniform(-2e-6, 2e-6)
    a3 = rng.uniform(-1e-9, 1e-9)
    a4 = rng.uniform(-1e-13, 1e-13)
    a5 = rng.uniform(-1.5e3, 1.5e3) * smh_spread
    a6 = rng.uniform(-3.0, 8.0) * smh_spread
    lo = [a0, a1, a2, a3, a4, a5, a6]
    # high range: same value-ish family, different coefficients
    hi = [a0 + rng.uniform(-0.5, 0.5), a1 * rng.uniform(0.3, 0.9),
          a2 * rng.uniform(0.1, 0.5), a3 * rng.uniform(0.1, 0.5),
          a4 * rng.uniform(0.1, 0.5), a5 + rng.uniform(-50, 50),
          a6 + rng.uniform(-1, 1)]

    comp = ''.join('{:<2s}{:>3d}'.format(el, n) for el, n in elems)
    comp = comp.ljust(20)
    line1 = '{:<18s}{:>6s}{}G{:>10.3f}{:>10.3f}{:>9.3f}{:>6s}1'.format(
        name, '', comp, 300.0, 5000.0, 1000.0, '')
    line2 = _fmt_nasa_line(hi, 5) + '    2'
    line3 = _fmt_nasa_line(hi[5:7] + lo[0:3], 5) + '    3'
    line4 = _fmt_nasa_line(lo[3:7], 4) + '                   4'
    return '\n'.join([line1, line2, line3, line4])


def tiny_mechanism(a5x: float = 36000.0) -> str:
    """A 4-species / 3-reaction mechanism (A+B<=>2X etc.) with
    parameterised product thermo.

    At ``a5x=36000`` the X enthalpy constant pushes kr = kf/Kc to
    ~2.6e39 — beyond the f32 exponent range while every finished
    Jacobian entry stays in range (trace-level X attenuates the
    reverse derivatives): the extreme-range fixture for the log-space
    dd path (reference f64 C handles this trivially,
    pyjac/core/rate_subs.py:660-809 Kc path).  At moderate values
    (e.g. ``a5x=3000``) it is simply the smallest well-posed reversible
    mechanism — the multi-chip dry run uses it because double-float
    graphs are expensive for XLA:CPU to compile and trace size scales
    with species count."""

    def nasa(name, comp, a5, a6=2.0):
        lo = [3.5, 1e-3, -1e-6, 1e-9, -1e-13, a5, a6]
        hi = [3.6, 8e-4, -5e-7, 5e-10, -5e-14, a5 + 30.0, a6 - 0.5]
        compstr = ''.join('{:<2s}{:>3d}'.format(el, n)
                          for el, n in comp).ljust(20)
        l1 = ('{:<18s}{:>6s}{}G{:>10.3f}{:>10.3f}{:>9.3f}{:>6s}1'
              .format(name, '', compstr, 300.0, 5000.0, 1000.0, ''))
        return '\n'.join([l1, _fmt_nasa_line(hi, 5) + '    2',
                          _fmt_nasa_line(hi[5:7] + lo[0:3], 5) + '    3',
                          _fmt_nasa_line(lo[3:7], 4)
                          + '                   4'])

    return '\n'.join([
        'ELEMENTS', 'H O N', 'END',
        'SPECIES', 'A B X N2', 'END',
        'THERMO ALL', '   300.000  1000.000  5000.000',
        nasa('A', [('H', 2)], -500.0),
        nasa('B', [('O', 2)], 300.0),
        nasa('X', [('H', 1), ('O', 1)], a5x),
        nasa('N2', [('N', 2)], -1000.0),
        'END',
        'REACTIONS',
        'A+B<=>2X                                 '
        '1.000E+13    0.000     8000.00',
        'A+X<=>B+X                                '
        '5.000E+11    0.300     6000.00',
        'A+A<=>B+N2                               '
        '2.000E+10    0.500    12000.00',
        'END'])


def synthetic_mechanism(n_species: int = 9, n_reactions: int = 24,
                        seed: int = 0, all_features: bool = True,
                        gri_mix: bool = False,
                        smh_spread: float = 1.0) -> str:
    """Return Chemkin mechanism text with the requested size.

    When ``all_features`` is set, the first ~10 reactions cycle through
    every special category; the rest are random elementary/third-body/
    falloff reactions.

    ``gri_mix`` (implies ``all_features=False``) matches the reaction-
    category proportions of real GRI-Mech 3.0 — ~87% reversible
    elementary, ~6% plain third-body, ~7% Troe/Lindemann falloff, a
    duplicate pair, and **no** PLOG/Chebyshev/SRI — so flagship
    benchmarks exercise the same kernel paths a real GRI-3.0 run would
    (the GRI/USC/LLNL source files themselves are not obtainable in
    this offline environment; see docs/performance.md).
    """
    rng = np.random.default_rng(seed)
    assert n_species >= 5

    elems = ['H', 'O', 'N', 'C'][: max(2, min(4, n_species // 2))]
    names = ['SP{}'.format(k) for k in range(n_species - 1)] + ['N2']

    out = io.StringIO()
    out.write('ELEMENTS\n' + ' '.join(elems) + '\nEND\n')
    out.write('SPECIES\n' + ' '.join(names) + '\nEND\n')
    out.write('THERMO ALL\n   300.000  1000.000  5000.000\n')
    for k, nm in enumerate(names):
        if nm == 'N2':
            comp = [('N', 2)]
        else:
            comp = [(elems[k % len(elems)], 1 + k % 3),
                    (elems[(k + 1) % len(elems)], 1)]
        out.write(_species_thermo(nm, comp, rng,
                                   smh_spread=smh_spread) + '\n')
    out.write('END\n')

    def pick(n, exclude=()):
        choices = [s for s in names[:-1] if s not in exclude]
        return list(rng.choice(choices, size=n, replace=False))

    def arr(order=2.0, scale=0.0):
        # pre-exponential in mol/cm^3 units such that the converted rate
        # constant is moderate for T in [800, 2500]
        A = 10.0 ** rng.uniform(7, 12) * 10.0 ** scale
        b = rng.uniform(-1.5, 2.0)
        E = rng.uniform(0.0, 3e4)    # cal/mol
        return A, b, E

    lines: List[str] = []

    def w(eq, A, b, E, extra: Optional[List[str]] = None):
        lines.append('{:<40s}{:>10.3E}{:>9.3f}{:>12.2f}'.format(eq, A, b, E))
        if extra:
            lines.extend(extra)

    count = 0
    if gri_mix:
        all_features = False
        # one duplicate pair (GRI has a handful)
        s = pick(4)
        A, b, E = arr()
        w('{}+{}<=>{}+{}'.format(*s[:4]), A, b, E, [' DUPLICATE'])
        w('{}+{}<=>{}+{}'.format(*s[:4]), A / 5, b, E * 1.05,
          [' DUPLICATE'])
        count = 2
    if all_features:
        s = pick(6)
        # 1: irreversible
        A, b, E = arr()
        w('{}+{}=>{}+{}'.format(*s[:4]), A, b, E)
        # 2: explicit REV (splits into two irreversible)
        A, b, E = arr()
        w('{}+{}={}+{}'.format(*s[:4]), A, b, E,
          ['REV / {:.3E} {:.3f} {:.1f} /'.format(*arr())])
        # 3: plain third-body
        A, b, E = arr(scale=-3)
        w('{}+{}+M<=>{}+M'.format(*s[:3]), A, b, E,
          ['{}/2.5/ {}/0.5/ {}/0.0/'.format(s[4], s[5], s[0])])
        # 4: Lindemann falloff (+M)
        A, b, E = arr()
        w('{}+{}(+M)<=>{}(+M)'.format(*s[:3]), A, b, E,
          ['LOW / {:.3E} {:.3f} {:.1f} /'.format(A * 1e3, b - 1.0, E / 2),
           '{}/2.0/ {}/6.0/'.format(s[4], s[5])])
        # 5: Troe falloff, 3-parameter
        A, b, E = arr()
        w('{}+{}(+M)<=>{}(+M)'.format(s[1], s[2], s[3]), A, b, E,
          ['LOW / {:.3E} {:.3f} {:.1f} /'.format(A * 5e2, b - 0.8, E / 3),
           'TROE / 0.62 98.0 1200.0 /'])
        # 6: Troe falloff, 4-parameter, specific collider
        A, b, E = arr()
        w('{}+{}(+{})<=>{}(+{})'.format(s[0], s[2], s[4], s[3], s[4]),
          A, b, E,
          ['LOW / {:.3E} {:.3f} {:.1f} /'.format(A * 2e3, b - 1.2, E / 2),
           'TROE / 0.7346 94.0 1756.0 5182.0 /'])
        # 7: SRI falloff, 5-parameter
        A, b, E = arr()
        w('{}+{}(+M)<=>{}+{}(+M)'.format(s[2], s[3], s[0], s[1]), A, b, E,
          ['LOW / {:.3E} {:.3f} {:.1f} /'.format(A * 1e3, b - 1.0, E / 2),
           'SRI / 1.1 700.0 1200.0 1.05 0.1 /',
           '{}/1.5/'.format(s[5])])
        # 8: chemically activated (HIGH)
        A, b, E = arr(scale=2)
        w('{}+{}(+M)<=>{}+{}(+M)'.format(s[0], s[1], s[2], s[4]), A, b, E,
          ['HIGH / {:.3E} {:.3f} {:.1f} /'.format(A / 1e4, b + 0.5, E / 2)])
        # 9: PLOG
        A, b, E = arr()
        w('{}+{}<=>{}+{}'.format(s[3], s[4], s[1], s[5]), A, b, E,
          ['PLOG / 0.1 {:.3E} {:.3f} {:.1f} /'.format(A / 10, b, E),
           'PLOG / 1.0 {:.3E} {:.3f} {:.1f} /'.format(A, b, E * 0.9),
           'PLOG / 10.0 {:.3E} {:.3f} {:.1f} /'.format(A * 5, b, E * 0.8)])
        # 10: Chebyshev
        cheb = rng.uniform(-0.1, 0.1, size=(4, 3))
        cheb[0, 0] = rng.uniform(6.0, 8.0)   # log10 k scale (cm^3/mol)
        rows = []
        # single-line PCHEB+TCHEB: the reference parser indexes past the
        # pressure pair unconditionally (mech_interpret.py:616) and
        # crashes on a standalone PCHEB card
        rows.append('PCHEB / 0.01 100.0 / TCHEB / 500.0 3000.0 /')
        rows.append('CHEB / 4 3 {} /'.format(
            ' '.join('{:.4E}'.format(v) for v in cheb[0])))
        for r in cheb[1:]:
            rows.append('CHEB / {} /'.format(
                ' '.join('{:.4E}'.format(v) for v in r)))
        w('{}+{}<=>{}+{}'.format(s[5], s[0], s[2], s[1]), 1.0, 0.0, 0.0,
          rows)
        # 11: duplicate pair
        A, b, E = arr()
        w('{}+{}<=>{}+{}'.format(s[1], s[4], s[0], s[3]), A, b, E,
          [' DUPLICATE'])
        w('{}+{}<=>{}+{}'.format(s[1], s[4], s[0], s[3]), A / 7, b, E * 1.1,
          [' DUPLICATE'])
        # 12: non-integer stoichiometry
        A, b, E = arr()
        w('{}+0.5{}<=>{}'.format(s[0], s[1], s[2]), A, b, E)
        count = 13

    # category proportions: GRI-3.0 is ~87% elementary / ~6% third-body
    # / ~7% falloff; the generic mix is 60/20/20.  The non-gri draw
    # must stay integers(0, 10): pinned seeds (golden fixtures)
    # reproduce the mechanism from the generator's RNG stream.
    while count < n_reactions:
        if gri_mix:
            kind = float(rng.integers(0, 100)) / 10.0
            elem_cut, thd_cut = 8.7, 9.3
        else:
            kind = rng.integers(0, 10)
            elem_cut, thd_cut = 6, 8
        s = pick(4)
        A, b, E = arr()
        if kind < elem_cut:
            nu = '2' if rng.random() < 0.2 else ''
            w('{}{}+{}<=>{}+{}'.format(nu, *s[:4]), A, b, E)
        elif kind < thd_cut:
            w('{}+{}+M<=>{}+M'.format(*s[:3]), A / 1e3, b, E,
              ['{}/{:.2f}/ {}/{:.2f}/'.format(s[3], rng.uniform(0, 3),
                                              s[0], rng.uniform(0, 3))])
        else:
            w('{}+{}(+M)<=>{}(+M)'.format(*s[:3]), A, b, E,
              ['LOW / {:.3E} {:.3f} {:.1f} /'.format(A * 1e3, b - 1.0,
                                                     E / 2),
               'TROE / 0.6 150.0 1400.0 /'])
        count += 1

    out.write('REACTIONS\n')
    out.write('\n'.join(lines))
    out.write('\nEND\n')
    return out.getvalue()


def _plausible_thermo(name: str, elems, n_units: int, rng) -> str:
    """NASA-7 entry with thermodynamically plausible coefficients for a
    species of ``n_units`` CH2 polymer units: cp grows with molecular
    size and stays positive over [300, 5000] K (rejection-sampled),
    formation enthalpy is a bounded offset from the size-proportional
    baseline (so balanced reactions have |dH| <~ 20 kJ/mol), and the
    entropy constant scales with size."""
    T = np.linspace(300.0, 5000.0, 48)
    for _ in range(64):
        a0 = 2.7 + 1.1 * n_units + rng.uniform(-0.15, 0.15)
        a1 = n_units * rng.uniform(0.5e-3, 1.5e-3)
        a2 = -n_units * rng.uniform(0.05e-6, 0.25e-6)
        a3 = n_units * rng.uniform(0.005e-9, 0.04e-9)
        a4 = -n_units * rng.uniform(0.002e-13, 0.02e-13)
        a5 = -180.0 * n_units + rng.uniform(-600.0, 600.0)
        a6 = 1.5 + 2.0 * n_units + rng.uniform(-0.8, 0.8)
        lo = [a0, a1, a2, a3, a4, a5, a6]
        hi = [a0 + rng.uniform(0.2, 0.6), a1 * rng.uniform(0.25, 0.5),
              a2 * rng.uniform(0.1, 0.3), a3 * rng.uniform(0.1, 0.3),
              a4 * rng.uniform(0.1, 0.3), a5 + rng.uniform(-40.0, 40.0),
              a6 + rng.uniform(-0.6, 0.6)]
        cp_lo = (lo[0] + lo[1] * T + lo[2] * T ** 2 + lo[3] * T ** 3 +
                 lo[4] * T ** 4)
        cp_hi = (hi[0] + hi[1] * T + hi[2] * T ** 2 + hi[3] * T ** 3 +
                 hi[4] * T ** 4)
        if (cp_lo > 1.5).all() and (cp_hi > 1.5).all():
            break
    comp = ''.join('{:<2s}{:>3d}'.format(el, n) for el, n in elems)
    comp = comp.ljust(20)
    line1 = '{:<18s}{:>6s}{}G{:>10.3f}{:>10.3f}{:>9.3f}{:>6s}1'.format(
        name, '', comp, 300.0, 5000.0, 1000.0, '')
    return '\n'.join([line1, _fmt_nasa_line(hi, 5) + '    2',
                      _fmt_nasa_line(hi[5:7] + lo[0:3], 5) + '    3',
                      _fmt_nasa_line(lo[3:7], 4) + '                   4'])


def plausible_mechanism(n_species: int = 53, n_reactions: int = 325,
                        seed: int = 42) -> str:
    """GRI-proportioned mechanism that is **time-integrable** (PaSR
    runs converge), unlike :func:`synthetic_mechanism`'s random thermo
    (measured dT/dt ~ -1.6e21 K/s at mixed inlets).

    Design for thermodynamic consistency (round-3 verdict item 8; the
    reference benches on PaSR-sampled states,
    pyjac/performance_tester/performance_tester.py:316-338):

    * every non-inert species is a polymer of ``n_k`` CH2 units, so a
      reaction is element-balanced iff it conserves the total unit
      count — all generated reactions do;
    * formation enthalpies are ``-180*n_k + delta_k`` with bounded
      ``delta``: the size-proportional baseline cancels in every
      balanced reaction, leaving |dH_rxn| <= ~20 kJ/mol — bounded heat
      release, bounded |ln Kc|, no runaway;
    * cp/S scale with molecular size and cp stays positive on
      [300, 5000] K (rejection-sampled);
    * category mix matches GRI-3.0 (~87% reversible elementary, ~6%
      third-body, ~7% Troe/Lindemann falloff, one duplicate pair, no
      PLOG/Chebyshev/SRI) — the same kernel paths as the flagship.
    """
    rng = np.random.default_rng(seed)
    assert n_species >= 8
    n_sp = n_species - 1                    # last species is inert N2
    names = ['SP{}'.format(k) for k in range(n_sp)] + ['N2']
    # sizes 1..4 with all sizes represented
    sizes = np.asarray([1 + (k % 4) for k in range(n_sp)])
    rng.shuffle(sizes)
    by_size = {s: [names[k] for k in range(n_sp) if sizes[k] == s]
               for s in (1, 2, 3, 4)}
    size_of = {names[k]: int(sizes[k]) for k in range(n_sp)}

    out = io.StringIO()
    out.write('ELEMENTS\nH C N\nEND\n')
    out.write('SPECIES\n' + ' '.join(names) + '\nEND\n')
    out.write('THERMO ALL\n   300.000  1000.000  5000.000\n')
    for k, nm in enumerate(names):
        if nm == 'N2':
            out.write(_plausible_thermo(nm, [('N', 2)], 2, rng) + '\n')
        else:
            n_u = int(sizes[k])
            out.write(_plausible_thermo(
                nm, [('C', n_u), ('H', 2 * n_u)], n_u, rng) + '\n')
    out.write('END\n')

    def pick_size(s):
        return by_size[s][int(rng.integers(0, len(by_size[s])))]

    def exchange():
        """A+B<=>C+D conserving total unit count."""
        na = int(rng.integers(1, 4))
        nb = int(rng.integers(1, 4))
        tot = na + nb
        parts = [(p, tot - p) for p in (1, 2, 3, 4)
                 if 1 <= tot - p <= 4]
        nc, nd = parts[int(rng.integers(0, len(parts)))]
        return (pick_size(na), pick_size(nb), pick_size(nc),
                pick_size(nd))

    def assoc():
        """A+B -> C with n_C = n_A + n_B (<= 4)."""
        na = int(rng.integers(1, 3))
        nb = int(rng.integers(1, 5 - na))
        return pick_size(na), pick_size(nb), pick_size(na + nb)

    def arr(lo=10.0, hi=13.3, bl=-0.7, bh=1.2, el=0.0, eh=45000.0):
        return (10.0 ** rng.uniform(lo, hi), rng.uniform(bl, bh),
                rng.uniform(el, eh))

    lines: List[str] = []

    def w(eq, A, b, E, extra: Optional[List[str]] = None):
        lines.append('{:<40s}{:>10.3E}{:>9.3f}{:>12.2f}'.format(
            eq, A, b, E))
        if extra:
            lines.extend(extra)

    a_, b_, c_, d_ = exchange()
    A, b, E = arr()
    w('{}+{}<=>{}+{}'.format(a_, b_, c_, d_), A, b, E, [' DUPLICATE'])
    w('{}+{}<=>{}+{}'.format(a_, b_, c_, d_), A / 5, b, E * 1.05,
      [' DUPLICATE'])
    count = 2
    while count < n_reactions:
        kind = float(rng.integers(0, 100)) / 10.0
        if kind < 8.7:
            a_, b_, c_, d_ = exchange()
            A, b, E = arr()
            w('{}+{}<=>{}+{}'.format(a_, b_, c_, d_), A, b, E)
        elif kind < 9.3:
            a_, b_, c_ = assoc()
            A, b, E = arr(lo=11.0, hi=14.0, el=0.0, eh=8000.0)
            w('{}+{}+M<=>{}+M'.format(a_, b_, c_), A / 1e3, b, E,
              ['{}/{:.2f}/ {}/{:.2f}/'.format(
                  'N2', rng.uniform(0.5, 2.0),
                  pick_size(1), rng.uniform(0.5, 3.0))])
        else:
            a_, b_, c_ = assoc()
            A, b, E = arr(lo=11.0, hi=13.5, bl=-1.0, bh=0.5, el=0.0,
                          eh=8000.0)
            extra = ['LOW / {:.3E} {:.3f} {:.1f} /'.format(
                A * 10.0 ** rng.uniform(2.5, 3.5), b - 1.0, E / 2)]
            if rng.random() < 0.7:
                extra.append('TROE / {:.3f} {:.1f} {:.1f} /'.format(
                    rng.uniform(0.3, 0.9), rng.uniform(80.0, 300.0),
                    rng.uniform(1000.0, 3000.0)))
            w('{}+{}(+M)<=>{}(+M)'.format(a_, b_, c_), A, b, E, extra)
        count += 1

    out.write('REACTIONS\n')
    out.write('\n'.join(lines))
    out.write('\nEND\n')
    return out.getvalue()


def random_states(mech, n_states: int, seed: int = 0,
                  T_range=(800.0, 2500.0), P_range=(0.5e5, 5e5)):
    """Random thermochemical state batch for a mechanism.

    Returns (y, T, P) with y = [T, Y_1..Y_{N-1}] and strictly positive
    mass fractions summing to < 1.
    """
    rng = np.random.default_rng(seed)
    N = mech.n_species
    T = rng.uniform(*T_range, size=n_states)
    P = rng.uniform(*P_range, size=n_states)
    x = rng.dirichlet(np.full(N, 0.8), size=n_states)
    # keep every species present at a floor so concentration powers and
    # their derivatives stay well-defined
    x = (x + 1e-6) / (1.0 + N * 1e-6)
    y = np.concatenate([T[:, None], x[:, :-1]], axis=1)
    return y, T, P
