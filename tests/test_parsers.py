"""Parser tests: Chemkin and CTI front ends.

Mirrors the information the reference's interpreter extracts from the
H2/O2 fixture (reference: pyjac/core/mech_interpret.py) and checks the
two formats agree bit-for-bit on shared content.
"""

import numpy as np
import pytest

from pyjac_jax.core.chemkin import read_mech
from pyjac_jax.core.cti import read_mech_cti
from pyjac_jax.core.mech import Mechanism, get_species_mappings
from pyjac_jax.testers.synthetic import synthetic_mechanism


def test_h2o2_inp_counts(h2o2_inp):
    elems, specs, reacs = read_mech(h2o2_inp)
    assert elems == ['O', 'H', 'AR']
    assert [s.name for s in specs] == [
        'H2', 'H', 'O', 'O2', 'OH', 'H2O', 'HO2', 'H2O2', 'AR']
    assert len(reacs) == 28
    # known molecular weights
    mw = {s.name: s.mw for s in specs}
    assert abs(mw['H2'] - 2 * 1.00794) < 1e-12
    assert abs(mw['H2O'] - (2 * 1.00794 + 15.9994)) < 1e-12


def test_h2o2_inp_details(h2o2_inp):
    _, specs, reacs = read_mech(h2o2_inp)
    names = [s.name for s in specs]
    # reaction 0: 2O+M<=>O2+M, A=1.2e17 cm^3 -> /1000^2 (third body)
    r = reacs[0]
    assert r.thd_body and not r.pdep and r.rev
    assert r.reac == ['O'] and r.reac_nu == [2]
    assert r.A == 1.2e17 / 1000.0 ** 2
    assert r.b == -1.0 and r.E == 0.0
    assert sorted(r.thd_body_eff) == [['AR', 0.83], ['H2', 2.4],
                                      ['H2O', 15.4]]
    # reaction 2: O+H2<=>H+OH elementary, E = 6260 cal/mol -> K
    r = reacs[2]
    assert r.A == 3.87e4 / 1000.0
    assert abs(r.E - 6260.0 * 4.184 / 8.3144621) < 1e-9
    # reaction 20: Troe falloff 2OH(+M)<=>H2O2(+M)
    r = reacs[20]
    assert r.pdep and not r.thd_body and r.pdep_sp == ''
    assert r.A == 7.4e13 / 1000.0            # order-2 high-pressure limit
    assert r.low[0] == 2.3e18 / 1000.0 ** 2  # order-2 LOW
    assert r.troe and r.troe_par == [0.7346, 94.0, 1756.0, 5182.0]
    # duplicates flagged
    assert reacs[22].dup and reacs[23].dup


def test_thermo_values(h2o2_inp):
    _, specs, _ = read_mech(h2o2_inp)
    h2 = next(s for s in specs if s.name == 'H2')
    assert h2.Trange == [200.0, 1000.0, 3500.0]
    assert h2.lo[0] == 2.34433112e0
    assert h2.hi[0] == 3.33727920e0
    assert h2.hi[6] == -3.20502331e0
    assert h2.lo[6] == 6.83010238e-1


def test_cti_matches_chemkin(h2o2_inp, h2o2_cti):
    _, specs, reacs = read_mech(h2o2_inp)
    _, s2, r2 = read_mech_cti(h2o2_cti)
    byname = {s.name: s for s in s2}
    for s in specs:
        t = byname[s.name]
        assert s.mw == t.mw
        np.testing.assert_array_equal(s.hi, t.hi)
        np.testing.assert_array_equal(s.lo, t.lo)
    assert len(reacs) == len(r2)
    for a, b in zip(reacs, r2):
        assert sorted(a.reac) == sorted(b.reac)
        assert sorted(a.prod) == sorted(b.prod)
        assert a.A == b.A and a.b == b.b and a.E == b.E
        assert (a.rev, a.thd_body, a.pdep, a.dup) == \
               (b.rev, b.thd_body, b.pdep, b.dup)
        assert a.low == b.low and a.troe_par == b.troe_par
        assert sorted(map(tuple, a.thd_body_eff)) == \
               sorted(map(tuple, b.thd_body_eff))


def test_species_mappings():
    fwd, back = get_species_mappings(5, 2)
    assert fwd == [0, 1, 3, 4, 2]
    assert back == [0, 1, 4, 2, 3]
    for new, old in enumerate(fwd):
        assert back[old] == new


def test_last_species_pivot(h2o2_cti):
    m = Mechanism.from_files(h2o2_cti)
    assert m.specs[-1].name == 'N2'
    # user override
    m2 = Mechanism.from_files(h2o2_cti, last_spec='AR')
    assert m2.specs[-1].name == 'AR'


def test_synthetic_all_features(tmp_path):
    text = synthetic_mechanism(n_species=9, n_reactions=24, seed=3)
    path = tmp_path / 'synth.inp'
    path.write_text(text)
    elems, specs, reacs = read_mech(str(path))
    assert len(specs) == 9
    # explicit REV reactions are split into two irreversible ones
    assert len(reacs) == 25
    assert any(r.plog for r in reacs)
    assert any(r.cheb for r in reacs)
    assert any(r.sri for r in reacs)
    assert any(r.troe for r in reacs)
    assert any(r.pdep and r.high for r in reacs)       # chem-activated
    assert any(r.pdep and isinstance(r.pdep_sp, str) and r.pdep_sp
               for r in reacs)                          # specific collider
    assert any(not r.rev for r in reacs)
    assert any(any(float(nu) != int(nu) for nu in r.reac_nu)
               for r in reacs)                          # fractional nu
    rev_split = [r for r in reacs if not r.rev and not r.rev_par]
    assert len(rev_split) >= 3
    cheb = next(r for r in reacs if r.cheb)
    assert cheb.cheb_par.shape == (4, 3)
    assert cheb.cheb_tlim == [500.0, 3000.0]
    plog = next(r for r in reacs if r.plog)
    assert len(plog.plog_par) == 3
    assert plog.plog_par[0][0] == 0.1 * 101325.0


def test_troe_zero_guard(tmp_path):
    text = """ELEMENTS
H O
END
SPECIES
A1 B1 C1
END
THERMO ALL
   300.000  1000.000  5000.000
A1                      H   1O   1          G    300.000  5000.000 1000.000    1
 2.50000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00    2
-7.45375000E+02 4.36600000E+00 2.50000000E+00 0.00000000E+00 0.00000000E+00    3
 0.00000000E+00 0.00000000E+00-7.45375000E+02 4.36600000E+00                   4
B1                      H   2               G    300.000  5000.000 1000.000    1
 2.50000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00    2
-7.45375000E+02 4.36600000E+00 2.50000000E+00 0.00000000E+00 0.00000000E+00    3
 0.00000000E+00 0.00000000E+00-7.45375000E+02 4.36600000E+00                   4
C1                      O   2               G    300.000  5000.000 1000.000    1
 2.50000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00    2
-7.45375000E+02 4.36600000E+00 2.50000000E+00 0.00000000E+00 0.00000000E+00    3
 0.00000000E+00 0.00000000E+00-7.45375000E+02 4.36600000E+00                   4
END
REACTIONS
A1+B1(+M)<=>C1(+M)    1.0E13  0.0  0.0
LOW / 1.0E16 0.0 0.0 /
TROE / 0.5 0.0 100.0 /
END
"""
    path = tmp_path / 'troe.inp'
    path.write_text(text)
    _, _, reacs = read_mech(str(path))
    # zero T3 replaced by 1e-30 (reference: mech_interpret.py:551-560)
    assert reacs[0].troe_par[1] == 1e-30
    assert reacs[0].troe_par[2] == 100.0


def test_negative_plog_A_rejected(tmp_path):
    """pack() must reject PLOG entries with A < 0: log-interpolating
    |A| would silently flip the rate's sign (ADVICE r1)."""
    from pyjac_jax.core.pack import pack as pack_fn
    text = synthetic_mechanism(n_species=9, n_reactions=14, seed=3)
    text = text.replace('PLOG / 1.0 ', 'PLOG / 1.0 -', 1)
    path = tmp_path / 'negplog.inp'
    path.write_text(text)
    mech = Mechanism.from_files(str(path))
    with pytest.raises(NotImplementedError, match='PLOG'):
        pack_fn(mech)
