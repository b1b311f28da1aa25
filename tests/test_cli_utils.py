"""CLI and state-utility tests."""

import json
import os

import numpy as np
import pytest

from pyjac_jax import utils
from pyjac_jax.cli import main as cli_main
from pyjac_jax.core.pack import load_packed, save_packed


def test_mass_mole_roundtrip(small_packed):
    rng = np.random.default_rng(0)
    X = rng.dirichlet(np.ones(small_packed.n_species), size=5)
    Y = utils.mole_to_mass(small_packed, X)
    X2 = utils.mass_to_mole(small_packed, Y)
    np.testing.assert_allclose(X, X2, rtol=1e-12)
    np.testing.assert_allclose(Y.sum(axis=-1), 1.0, rtol=1e-12)


def test_density(small_packed):
    # one pure species at 300 K, 1 atm: rho = P W / (R T)
    Y = np.zeros(small_packed.n_species)
    Y[0] = 1.0
    rho = utils.get_density(small_packed, 300.0, 101325.0, Y)
    expect = 101325.0 * float(small_packed.mw[0]) / (8314.4621 * 300.0)
    assert rho == pytest.approx(expect, rel=1e-12)


def test_parse_initial_conditions(small_packed):
    T, P, Y = utils.parse_initial_conditions(
        small_packed, '800, 2, SP0=2.0, SP1=1.0, N2=3.76')
    assert T == 800.0
    assert P == pytest.approx(2 * 101325.0)
    assert Y.sum() == pytest.approx(1.0)
    X = utils.mass_to_mole(small_packed, Y)
    names = small_packed.species_names
    assert X[names.index('SP0')] == pytest.approx(2.0 / 6.76, rel=1e-12)
    with pytest.raises(ValueError):
        utils.parse_initial_conditions(small_packed, '800,1,NOPE=1')
    with pytest.raises(ValueError):
        utils.parse_initial_conditions(small_packed, '800,1')


def test_permutations(small_packed, small_rows):
    orig = small_rows[0, 3:]
    internal = utils.permute_to_internal(small_packed, orig)
    back = utils.permute_to_original(small_packed, internal)
    np.testing.assert_array_equal(orig, back)


def test_state_vector_roundtrip(small_packed):
    rng = np.random.default_rng(1)
    Yf = rng.dirichlet(np.ones(small_packed.n_species), size=3)
    y = utils.state_vector(small_packed, np.full(3, 1000.0), Yf)
    assert y.shape == (3, small_packed.n_species)
    Yr = utils.full_mass_fractions(y)
    np.testing.assert_allclose(Yr, Yf, atol=1e-15)


def test_save_load_packed(small_packed, tmp_path):
    path = str(tmp_path / 'mech.npz')
    save_packed(small_packed, path)
    loaded = load_packed(path)
    assert loaded.n_species == small_packed.n_species
    assert loaded.has_troe == small_packed.has_troe
    np.testing.assert_array_equal(loaded.nu_net, small_packed.nu_net)
    np.testing.assert_array_equal(loaded.logA, small_packed.logA)
    assert loaded.species_names == small_packed.species_names


@pytest.fixture
def small_inp(tmp_path):
    """The in-repo 12/30 mechanism as a Chemkin file."""
    from pyjac_jax.testers.synthetic import plausible_mechanism
    path = tmp_path / 'small.inp'
    path.write_text(plausible_mechanism(12, 30, seed=2))
    return str(path)


def test_cli_pack_and_validate(small_inp, small_packed, tmp_path):
    build = str(tmp_path / 'out')
    rc = cli_main(['-i', small_inp, '-b', build, '-ls', 'N2',
                   '-ic', '1000,1,SP0=2,SP1=1,N2=3.76',
                   '--validate', '--states', '4'])
    assert rc == 0
    manifest = json.load(open(os.path.join(build, 'mechanism_info.json')))
    assert manifest['NSP'] == 12
    assert manifest['FWD_RATES'] == 30
    assert manifest['PRES_MOD_RATES'] == small_packed.n_pres_mod == 5
    assert manifest['last_species'] == 'N2'
    assert manifest['features']['troe'] is True
    assert manifest['features']['plog'] is False
    assert os.path.exists(os.path.join(build, 'mech_packed.npz'))
    assert os.path.exists(os.path.join(build, 'initial_state.npy'))
    loaded = load_packed(os.path.join(build, 'mech_packed.npz'))
    assert loaded.n_reactions == 30


def test_cli_conv_validate(small_inp, tmp_path):
    rc = cli_main(['-i', small_inp, '-b', str(tmp_path / 'o'), '--conv',
                   '--validate', '--states', '3'])
    assert rc == 0


def test_cli_lang_is_jax_only(small_inp, tmp_path):
    """--lang keeps the reference's flag; JAX is its only value."""
    assert cli_main(['-i', small_inp, '-b', str(tmp_path / 'o3'),
                     '-l', 'jax']) == 0
    with pytest.raises(SystemExit):
        cli_main(['-i', small_inp, '-b', str(tmp_path / 'o4'),
                  '-l', 'cuda'])


def test_cli_skip_jac(small_inp, tmp_path):
    rc = cli_main(['-i', small_inp, '-b', str(tmp_path / 'o2'),
                   '--skip_jac', '--validate'])
    assert rc == 0
