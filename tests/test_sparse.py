"""Structural sparsity mask vs the actual numerical Jacobian."""

import jax.numpy as jnp
import numpy as np
import pytest

from pyjac_jax.ops.jacobian import eval_jacobian
from pyjac_jax.ops.sparse import sparsity_summary, structural_sparsity
from pyjac_jax.ops.thermo import eval_conc


@pytest.mark.parametrize('conp', [True, False])
def test_mask_covers_numerical_jacobian(small_packed, small_states, conp):
    """Entries outside the structural mask must be numerically zero."""
    st = small_states
    sel = np.linspace(0, len(st['T']) - 1, 30).astype(int)
    y = jnp.asarray(st['y'][sel])
    P = jnp.asarray(st['P'][sel])
    if conp:
        param = P
    else:
        T = jnp.asarray(st['T'][sel])
        Y = jnp.asarray(st['Y_full'][sel, :-1])
        _, _, param, _ = eval_conc(small_packed, T, P, Y)
    J = np.asarray(eval_jacobian(small_packed, 0.0, param, y, conp=conp))
    mask = structural_sparsity(small_packed, conp=conp)
    outside = J[:, ~mask]
    scale = np.abs(J).max()
    assert np.abs(outside).max(initial=0.0) <= scale * 1e-14


def test_summary(small_packed):
    s = sparsity_summary(small_packed)
    assert 0 < s['conv']['fill'] <= s['conp']['fill'] <= 1.0
    assert s['conp']['total'] == small_packed.n_species ** 2


@pytest.mark.parametrize('conp', [True, False])
def test_mask_covers_synthetic_with_plog_cheb(conp, tmp_path):
    """CONV coupling through P(mw_avg(Y)) for PLOG/Chebyshev rows must
    be inside the structural mask (ADVICE r1)."""
    from pyjac_jax.core.mech import Mechanism
    from pyjac_jax.core.pack import pack
    from pyjac_jax.testers.synthetic import random_states, \
        synthetic_mechanism

    path = tmp_path / 'synth.inp'
    path.write_text(synthetic_mechanism(n_species=9, n_reactions=24,
                                        seed=7))
    mech = Mechanism.from_files(str(path))
    packed = pack(mech)
    assert packed.has_plog and packed.has_cheb

    y, T, P = random_states(mech, 24, seed=11)
    if conp:
        param = jnp.asarray(P)
    else:
        _, _, param, _ = eval_conc(packed, jnp.asarray(T),
                                   jnp.asarray(P),
                                   jnp.asarray(y[:, 1:]))
    J = np.asarray(eval_jacobian(packed, 0.0, param, jnp.asarray(y),
                                 conp=conp))
    mask = structural_sparsity(packed, conp=conp)
    outside = J[:, ~mask]
    scale = np.abs(J).max()
    if outside.size:
        assert np.abs(outside).max(initial=0.0) <= scale * 1e-14
    if not conp:
        # rows of species produced by PLOG/Chebyshev reactions must be
        # fully dense: P depends on mw_avg(Y) under CONV
        nu = np.asarray(packed.nu_net)
        pd = np.zeros(nu.shape[0], dtype=bool)
        pd[np.asarray(packed.plog_idx)] = True
        pd[np.asarray(packed.cheb_idx)] = True
        touched = (np.abs(nu[pd]).sum(axis=0) != 0)[:-1]
        assert mask[1:, 1:][touched].all()


def test_csr_structure_roundtrip(small_mech):
    """CSR export matches the dense pattern and scipy reconstruction."""
    import jax.numpy as jnp

    from pyjac_jax.core.pack import pack
    from pyjac_jax.ops.jacobian import eval_jacobian
    from pyjac_jax.ops.sparse import (csr_structure, sparse_values,
                                      structural_sparsity)
    from pyjac_jax.testers.synthetic import random_states

    mech = small_mech
    packed = pack(mech)
    for conp in (True, False):
        mask = structural_sparsity(packed, conp)
        indptr, indices = csr_structure(packed, conp)
        assert indptr[-1] == mask.sum()
        assert len(indices) == mask.sum()
        y, _, P = random_states(mech, 4, seed=2)
        param = P if conp else np.full(4, 1.2)
        J = eval_jacobian(packed, 0.0, jnp.asarray(param),
                          jnp.asarray(y), conp=conp)
        data = np.asarray(sparse_values(J, indptr, indices))
        assert data.shape == (4, mask.sum())
        # dense entries OUTSIDE the pattern must be zero...
        np.testing.assert_array_equal(np.asarray(J)[:, ~mask], 0.0)
        # ...and the CSR data reconstructs the dense matrix
        try:
            from scipy.sparse import csr_matrix
        except ImportError:
            dense = np.zeros_like(np.asarray(J)[0])
            rows = np.repeat(np.arange(len(indptr) - 1),
                             np.diff(indptr))
            dense[rows, indices] = data[0]
        else:
            dense = csr_matrix(
                (data[0], indices, indptr), shape=mask.shape).toarray()
        np.testing.assert_array_equal(dense, np.asarray(J)[0])
