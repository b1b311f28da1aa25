"""Cantera-YAML front end: cross-validated against the Chemkin parser
on an equivalent dual-format mechanism."""

import numpy as np
import pytest

from pyjac_jax.core.chemkin import read_mech
from pyjac_jax.core.ctyaml import read_mech_yaml

CHEMKIN = """ELEMENTS
H O N
END
SPECIES
AB CD EF N2
END
THERMO ALL
   300.000  1000.000  5000.000
AB                      H   2O   1          G    300.000  5000.000 1000.000    1
 3.10000000E+00 1.00000000E-03 0.00000000E+00 0.00000000E+00 0.00000000E+00    2
-1.00000000E+03 4.00000000E+00 2.90000000E+00 2.00000000E-03 0.00000000E+00    3
 0.00000000E+00 0.00000000E+00-9.00000000E+02 5.00000000E+00                   4
CD                      O   2               G    300.000  5000.000 1000.000    1
 3.50000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00    2
-2.00000000E+03 3.00000000E+00 3.40000000E+00 1.00000000E-03 0.00000000E+00    3
 0.00000000E+00 0.00000000E+00-1.90000000E+03 3.50000000E+00                   4
EF                      H   1O   2          G    300.000  5000.000 1000.000    1
 4.00000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00    2
-3.00000000E+03 2.00000000E+00 3.90000000E+00 5.00000000E-04 0.00000000E+00    3
 0.00000000E+00 0.00000000E+00-2.90000000E+03 2.50000000E+00                   4
N2                      N   2               G    300.000  5000.000 1000.000    1
 2.92000000E+00 1.50000000E-03 0.00000000E+00 0.00000000E+00 0.00000000E+00    2
-9.20000000E+02 5.98000000E+00 3.30000000E+00 1.40000000E-03 0.00000000E+00    3
 0.00000000E+00 0.00000000E+00-1.02000000E+03 3.95000000E+00                   4
END
REACTIONS
AB+CD<=>EF               1.500E+13    0.500     2000.00
AB+AB+M<=>CD+M           2.000E+16   -1.000        0.00
EF/5.0/ N2/0.5/
AB+EF(+M)<=>CD+CD(+M)    7.400E+13   -0.370        0.00
LOW / 2.300E+18 -0.900 -1700.00 /
TROE / 0.7346 94.00 1756.00 5182.00 /
N2/0.7/
END
"""

YAML = """
units: {length: cm, time: s, quantity: mol, activation-energy: cal/mol}
phases:
- name: gas
  elements: [H, O, N]
  species: [AB, CD, EF, N2]
species:
- name: AB
  composition: {H: 2, O: 1}
  thermo:
    model: NASA7
    temperature-ranges: [300.0, 1000.0, 5000.0]
    data:
    - [2.9, 2.0e-03, 0.0, 0.0, 0.0, -900.0, 5.0]
    - [3.1, 1.0e-03, 0.0, 0.0, 0.0, -1000.0, 4.0]
- name: CD
  composition: {O: 2}
  thermo:
    model: NASA7
    temperature-ranges: [300.0, 1000.0, 5000.0]
    data:
    - [3.4, 1.0e-03, 0.0, 0.0, 0.0, -1900.0, 3.5]
    - [3.5, 0.0, 0.0, 0.0, 0.0, -2000.0, 3.0]
- name: EF
  composition: {H: 1, O: 2}
  thermo:
    model: NASA7
    temperature-ranges: [300.0, 1000.0, 5000.0]
    data:
    - [3.9, 5.0e-04, 0.0, 0.0, 0.0, -2900.0, 2.5]
    - [4.0, 0.0, 0.0, 0.0, 0.0, -3000.0, 2.0]
- name: N2
  composition: {N: 2}
  thermo:
    model: NASA7
    temperature-ranges: [300.0, 1000.0, 5000.0]
    data:
    - [3.3, 1.4e-03, 0.0, 0.0, 0.0, -1020.0, 3.95]
    - [2.92, 1.5e-03, 0.0, 0.0, 0.0, -920.0, 5.98]
reactions:
- equation: AB + CD <=> EF
  rate-constant: {A: 1.5e+13, b: 0.5, Ea: 2000.0}
- equation: AB + AB + M <=> CD + M
  type: three-body
  rate-constant: {A: 2.0e+16, b: -1.0, Ea: 0.0}
  efficiencies: {EF: 5.0, N2: 0.5}
- equation: AB + EF (+M) <=> CD + CD (+M)
  type: falloff
  high-P-rate-constant: {A: 7.4e+13, b: -0.37, Ea: 0.0}
  low-P-rate-constant: {A: 2.3e+18, b: -0.9, Ea: -1700.0}
  Troe: {A: 0.7346, T3: 94.0, T1: 1756.0, T2: 5182.0}
  efficiencies: {N2: 0.7}
- equation: AB + CD <=> EF + N2
  type: pressure-dependent-Arrhenius
  rate-constants:
  - {P: 0.1 atm, A: 1.0e+12, b: 0.0, Ea: 1000.0}
  - {P: 1.0 atm, A: 1.0e+13, b: 0.0, Ea: 900.0}
- equation: CD + EF <=> AB + N2
  type: Chebyshev
  temperature-range: [500.0, 3000.0]
  pressure-range: [0.01 atm, 100.0 atm]
  data:
  - [7.0, 0.1]
  - [0.05, -0.02]
"""


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp('yamlmech')
    ck = d / 'm.inp'
    ck.write_text(CHEMKIN)
    ym = d / 'm.yaml'
    ym.write_text(YAML)
    return read_mech(str(ck)), read_mech_yaml(str(ym))


def test_species_match(pair):
    (_, s1, _), (_, s2, _) = pair
    assert [s.name for s in s1] == [s.name for s in s2]
    for a, b in zip(s1, s2):
        assert a.mw == b.mw
        np.testing.assert_array_equal(a.hi, b.hi)
        np.testing.assert_array_equal(a.lo, b.lo)
        assert a.Trange == b.Trange


def test_shared_reactions_bit_identical(pair):
    (_, _, r1), (_, _, r2) = pair
    for a, b in zip(r1, r2[:3]):
        assert a.A == b.A and a.b == b.b and a.E == b.E
        assert a.rev == b.rev and a.thd_body == b.thd_body
        assert a.pdep == b.pdep
        assert a.low == b.low and a.troe_par == b.troe_par
        assert sorted(map(tuple, a.thd_body_eff)) == \
            sorted(map(tuple, b.thd_body_eff))


def test_yaml_plog_cheb(pair):
    (_, _, _), (_, _, r2) = pair
    plog = r2[3]
    assert plog.plog
    assert plog.plog_par[0][0] == pytest.approx(0.1 * 101325.0)
    # A = 1e12 / 1000^(order-1) with order 2
    assert plog.plog_par[0][1] == 1.0e12 / 1000.0
    cheb = r2[4]
    assert cheb.cheb and cheb.cheb_par.shape == (2, 2)
    assert cheb.cheb_tlim == [500.0, 3000.0]
    # constant term shifted by log10(0.001^(order-1))
    assert cheb.cheb_par[0, 0] == pytest.approx(7.0 - 3.0)


def test_yaml_through_full_pipeline(pair, tmp_path):
    """YAML -> Mechanism -> pack -> Jacobian vs AD."""
    import jax.numpy as jnp

    from pyjac_jax.core.mech import Mechanism
    from pyjac_jax.core.pack import pack
    from pyjac_jax.ops.jacobian import eval_jacobian, jacobian_fwd
    from pyjac_jax.testers.synthetic import random_states

    ym = tmp_path / 'm.yaml'
    ym.write_text(YAML)
    mech = Mechanism.from_files(str(ym))
    assert mech.specs[-1].name == 'N2'
    packed = pack(mech)
    y, T, P = random_states(mech, 8, seed=0)
    J = eval_jacobian(packed, 0.0, jnp.asarray(P), jnp.asarray(y))
    J_ref = jacobian_fwd(packed, 0.0, jnp.asarray(P), jnp.asarray(y))
    scale = float(jnp.abs(J_ref).max())
    assert float(jnp.abs(J - J_ref).max()) / scale < 1e-10
