"""AOT library export/load tests (the libgen analog)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from pyjac_jax.libgen import generate_library, load_library
from pyjac_jax.ops.jacobian import jacobian_and_dydt


def test_generate_and_load(small_packed, small_states, tmp_path):
    out = str(tmp_path / 'lib')
    man = generate_library(small_packed, out,
                           kernels=('dydt', 'jacobian_and_dydt'),
                           platforms=('cpu',))
    manifest = json.load(open(man))
    assert manifest['n_species'] == small_packed.n_species
    assert set(manifest['kernels']) == {'dydt', 'jacobian_and_dydt'}

    lib = load_library(out)
    st = small_states
    # symbolic batch: exercise two different batch sizes from ONE
    # artifact
    for B in (5, 17):
        sel = np.linspace(0, len(st['T']) - 1, B).astype(int)
        y = jnp.asarray(st['y'][sel])
        P = jnp.asarray(st['P'][sel])
        J, f = lib['jacobian_and_dydt'](P, y)
        J_ref, f_ref = jacobian_and_dydt(small_packed, 0.0, P, y)
        scale = float(jnp.abs(J_ref).max())
        np.testing.assert_allclose(np.asarray(J) / scale,
                                   np.asarray(J_ref) / scale, atol=1e-12)
        f2 = lib['dydt'](P, y)
        fscale = float(jnp.abs(f_ref).max())
        np.testing.assert_allclose(np.asarray(f2) / fscale,
                                   np.asarray(f_ref) / fscale, atol=1e-12)


def test_conv_rates_kernel(small_packed, small_states, tmp_path):
    """CONV 'rates' artifact must treat its param as density, not
    pressure (recovering P from rho via the gas law)."""
    from pyjac_jax.ops.rates import eval_rxn_rates, get_rxn_pres_mod
    from pyjac_jax.ops.thermo import eval_conc, eval_conc_rho

    out = str(tmp_path / 'libconv')
    generate_library(small_packed, out, kernels=('rates',), conp=False,
                     platforms=('cpu',))
    lib = load_library(out)
    assert lib['manifest']['param'].startswith('density')

    st = small_states
    sel = np.linspace(0, len(st['T']) - 1, 9).astype(int)
    T = jnp.asarray(st['T'][sel])
    P = jnp.asarray(st['P'][sel])
    Y = jnp.asarray(st['Y_full'][sel, :-1])
    _, _, rho, _ = eval_conc(small_packed, T, P, Y)
    y = jnp.asarray(st['y'][sel])

    fwd, rev, pm = lib['rates'](rho, y)
    _, _, pres, conc = eval_conc_rho(small_packed, T, rho, Y)
    fwd_ref, rev_ref = eval_rxn_rates(small_packed, T, pres, conc)
    pm_ref = get_rxn_pres_mod(small_packed, T, pres, conc)
    for a, b in ((fwd, fwd_ref), (rev, rev_ref), (pm, pm_ref)):
        scale = float(jnp.abs(b).max()) + 1e-300
        np.testing.assert_allclose(np.asarray(a) / scale,
                                   np.asarray(b) / scale, atol=1e-12)


def test_export_for_cpu_and_gpu(small_packed, tmp_path):
    """One artifact lowered for the CPU and for the GPU ('cuda', JAX's
    export platform name for an NVIDIA card) from a CPU-only host."""
    from jax import export

    out = tmp_path / 'lib'
    generate_library(small_packed, str(out), kernels=('jacobian',),
                     platforms=('cpu', 'cuda'))
    with open(out / 'jacobian_conp.jaxexport', 'rb') as fh:
        exp = export.deserialize(fh.read())
    assert exp.platforms == ('cpu', 'cuda')
    lib = load_library(str(out))
    y = jnp.ones((3, small_packed.n_species)) * 0.05
    y = y.at[:, 0].set(1500.0)
    J = lib['jacobian'](jnp.full((3,), 1e5), y)
    assert J.shape == (3, small_packed.n_species, small_packed.n_species)
    assert np.isfinite(np.asarray(J)).all()


def test_unknown_kernel_rejected(small_packed, tmp_path):
    with pytest.raises(ValueError, match='unknown kernel'):
        generate_library(small_packed, str(tmp_path / 'lib'),
                         kernels=('jacobian_sparse',))
