"""CTML (legacy Cantera ``.xml``) front end: cross-validated against
the YAML parser on an equivalent dual-format mechanism (CTML documents
are unit-normalized to SI kmol/m^3 by ``ctml_writer``, so the A values
below are the YAML/Chemkin values pre-converted)."""

import numpy as np
import pytest

from pyjac_jax.core.chemkin import MechanismError
from pyjac_jax.core.ctml import read_mech_ctml
from pyjac_jax.core.ctyaml import read_mech_yaml

from tests.test_yaml import YAML

_TH = """<thermo>
  <NASA Tmin="300.0" Tmax="1000.0" P0="100000.0">
    <floatArray name="coeffs" size="7">{lo}</floatArray>
  </NASA>
  <NASA Tmin="1000.0" Tmax="5000.0" P0="100000.0">
    <floatArray name="coeffs" size="7">{hi}</floatArray>
  </NASA>
</thermo>"""

CTML = """<?xml version="1.0"?>
<ctml>
  <phase dim="3" id="gas">
    <elementArray datasrc="elements.xml">H O N</elementArray>
    <speciesArray datasrc="#species_data">AB CD EF N2</speciesArray>
    <reactionArray datasrc="#reaction_data"/>
  </phase>
  <speciesData id="species_data">
    <species name="AB"><atomArray>H:2 O:1 </atomArray>{AB}</species>
    <species name="CD"><atomArray>O:2 </atomArray>{CD}</species>
    <species name="EF"><atomArray>H:1 O:2 </atomArray>{EF}</species>
    <species name="N2"><atomArray>N:2 </atomArray>{N2}</species>
  </speciesData>
  <reactionData id="reaction_data">
    <reaction reversible="yes" id="0001">
      <equation>AB + CD [=] EF</equation>
      <rateCoeff><Arrhenius>
        <A>1.5e+10</A><b>0.5</b><E units="cal/mol">2000.0</E>
      </Arrhenius></rateCoeff>
      <reactants>AB:1.0 CD:1.0</reactants>
      <products>EF:1.0</products>
    </reaction>
    <reaction reversible="yes" type="threeBody" id="0002">
      <equation>2 AB + M [=] CD + M</equation>
      <rateCoeff>
        <Arrhenius><A>2.0e+10</A><b>-1.0</b>
          <E units="cal/mol">0.0</E></Arrhenius>
        <efficiencies default="1.0">EF:5.0 N2:0.5</efficiencies>
      </rateCoeff>
      <reactants>AB:2.0</reactants>
      <products>CD:1.0</products>
    </reaction>
    <reaction reversible="yes" type="falloff" id="0003">
      <equation>AB + EF (+ M) [=] 2 CD (+ M)</equation>
      <rateCoeff>
        <Arrhenius><A>7.4e+10</A><b>-0.37</b>
          <E units="cal/mol">0.0</E></Arrhenius>
        <Arrhenius name="k0"><A>2.3e+12</A><b>-0.9</b>
          <E units="cal/mol">-1700.0</E></Arrhenius>
        <falloff type="Troe">0.7346 94.0 1756.0 5182.0</falloff>
        <efficiencies default="1.0">N2:0.7</efficiencies>
      </rateCoeff>
      <reactants>AB:1.0 EF:1.0</reactants>
      <products>CD:2.0</products>
    </reaction>
    <reaction reversible="yes" type="plog" id="0004">
      <equation>AB + CD [=] EF + N2</equation>
      <rateCoeff>
        <Arrhenius><P units="atm">0.1</P><A>1.0e+9</A><b>0.0</b>
          <E units="cal/mol">1000.0</E></Arrhenius>
        <Arrhenius><P units="atm">1.0</P><A>1.0e+10</A><b>0.0</b>
          <E units="cal/mol">900.0</E></Arrhenius>
      </rateCoeff>
      <reactants>AB:1.0 CD:1.0</reactants>
      <products>EF:1.0 N2:1.0</products>
    </reaction>
    <reaction reversible="yes" type="chebyshev" id="0005">
      <equation>CD + EF [=] AB + N2</equation>
      <rateCoeff>
        <Tmin>500.0</Tmin><Tmax>3000.0</Tmax>
        <Pmin units="atm">0.01</Pmin><Pmax units="atm">100.0</Pmax>
        <floatArray name="coeffs" degreeT="2" degreeP="2">
          4.0, 0.1, 0.05, -0.02</floatArray>
      </rateCoeff>
      <reactants>CD:1.0 EF:1.0</reactants>
      <products>AB:1.0 N2:1.0</products>
    </reaction>
    <reaction reversible="no" type="chemAct" duplicate="yes" id="0006">
      <equation>AB + CD (+ N2) =] EF (+ N2)</equation>
      <rateCoeff>
        <Arrhenius><A>3.0e+10</A><b>0.0</b>
          <E units="cal/mol">100.0</E></Arrhenius>
        <Arrhenius name="kHigh"><A>6.0e+7</A><b>0.5</b>
          <E units="cal/mol">50.0</E></Arrhenius>
        <falloff type="SRI">0.54 201.0 1024.0</falloff>
      </rateCoeff>
      <reactants>AB:1.0 CD:1.0</reactants>
      <products>EF:1.0</products>
    </reaction>
  </reactionData>
</ctml>"""


def _coeffs(row):
    return ', '.join('%.17g' % float(c) for c in row)


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp('ctmlmech')
    ym = d / 'm.yaml'
    ym.write_text(YAML)
    _, specs, _ = read_mech_yaml(str(ym))
    th = {s.name: _TH.format(lo=_coeffs(s.lo), hi=_coeffs(s.hi))
          for s in specs}
    xml = d / 'm.xml'
    xml.write_text(CTML.format(**th))
    return read_mech_yaml(str(ym)), read_mech_ctml(str(xml))


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
    assert len(r2) == 6
    for a, b in zip(r1, r2[:5]):
        assert a.A == b.A and a.b == b.b and a.E == b.E
        assert a.rev == b.rev and a.thd_body == b.thd_body
        assert a.pdep == b.pdep
        assert a.low == b.low and a.troe_par == b.troe_par
        assert a.reac_nu == b.reac_nu and a.prod_nu == b.prod_nu
        assert sorted(map(tuple, a.thd_body_eff)) == \
            sorted(map(tuple, b.thd_body_eff))
        assert a.plog == b.plog and a.plog_par == b.plog_par
        assert a.cheb == b.cheb
        if a.cheb:
            np.testing.assert_array_equal(a.cheb_par, b.cheb_par)
            assert a.cheb_tlim == b.cheb_tlim
            assert a.cheb_plim == b.cheb_plim


def test_chemact_sri(pair):
    _, (_, _, r2) = pair
    r = r2[5]
    assert r.pdep and not r.rev and r.dup
    assert r.pdep_sp == 'N2'
    assert r.sri and r.sri_par == [0.54, 201.0, 1024.0]
    assert r.high[0] == 6.0e7 and r.high[1] == 0.5
    assert r.A == 3.0e10


def test_bad_ctml(tmp_path):
    p = tmp_path / 'bad.xml'
    p.write_text('<notctml/>')
    with pytest.raises(MechanismError):
        read_mech_ctml(str(p))
    p.write_text('not xml at all <<<')
    with pytest.raises(MechanismError):
        read_mech_ctml(str(p))


def test_ctml_through_full_pipeline(pair, tmp_path):
    """CTML -> Mechanism -> pack -> Jacobian vs AD."""
    import jax.numpy as jnp

    from pyjac_jax.core.mech import Mechanism
    from pyjac_jax.core.pack import pack
    from pyjac_jax.ops.jacobian import eval_jacobian, jacobian_fwd
    from pyjac_jax.testers.synthetic import random_states

    _, specs, _ = pair[0]
    th = {s.name: _TH.format(lo=_coeffs(s.lo), hi=_coeffs(s.hi))
          for s in specs}
    xml = tmp_path / 'm.xml'
    xml.write_text(CTML.format(**th))
    mech = Mechanism.from_files(str(xml))
    assert mech.specs[-1].name == 'N2'
    packed = pack(mech)
    y, T, P = random_states(mech, 8, seed=0)
    J = eval_jacobian(packed, 0.0, jnp.asarray(P), jnp.asarray(y))
    J_ref = jacobian_fwd(packed, 0.0, jnp.asarray(P), jnp.asarray(y))
    scale = float(jnp.abs(J_ref).max())
    assert float(jnp.abs(J - J_ref).max()) / scale < 1e-10
