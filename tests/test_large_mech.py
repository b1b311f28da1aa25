"""Mechanism-size scaling (the reference's unroll/tiling axis):
USC-Mech II and LLNL n-heptane class sizes, per BASELINE configs."""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest

from pyjac_jax.core.mech import Mechanism
from pyjac_jax.core.pack import pack
from pyjac_jax.ops.jacobian import eval_jacobian, jacobian_fwd
from pyjac_jax.ops.sparse import structural_sparsity
from pyjac_jax.testers.synthetic import random_states, synthetic_mechanism


def _build(n_species, n_reactions, seed=5):
    text = synthetic_mechanism(n_species=n_species,
                               n_reactions=n_reactions, seed=seed)
    with tempfile.NamedTemporaryFile('w', suffix='.inp',
                                     delete=False) as fh:
        fh.write(text)
        path = fh.name
    mech = Mechanism.from_files(path)
    return mech, pack(mech)


def test_usc2_scale_jacobian():
    """111 species / 784 reactions (USC-Mech II size)."""
    mech, packed = _build(111, 784)
    y, T, P = random_states(mech, 4, seed=3)
    J = eval_jacobian(packed, 0.0, jnp.asarray(P), jnp.asarray(y))
    Jf = jacobian_fwd(packed, 0.0, jnp.asarray(P), jnp.asarray(y))
    scale = float(jnp.abs(Jf).max())
    assert float(jnp.abs(J - Jf).max()) / scale < 1e-10
    mask = structural_sparsity(packed, conp=True)
    assert mask.shape == (111, 111)


@pytest.mark.slow
def test_nheptane_scale_jacobian():
    """654 species / 2716 reactions (LLNL n-heptane size)."""
    mech, packed = _build(654, 2716)
    assert packed.n_species == 654
    y, T, P = random_states(mech, 2, seed=3)
    J = eval_jacobian(packed, 0.0, jnp.asarray(P), jnp.asarray(y))
    Jf = jacobian_fwd(packed, 0.0, jnp.asarray(P), jnp.asarray(y))
    scale = float(jnp.abs(Jf).max())
    assert float(jnp.abs(J - Jf).max()) / scale < 1e-10


def test_batch_evaluator_chunks_scale_with_mechanism():
    from pyjac_jax.parallel.mesh import BatchEvaluator, make_mesh
    mech, packed = _build(111, 784)
    ev = BatchEvaluator(packed, make_mesh(1))
    # 2 GB budget over (R x N x 8B) per state
    assert ev.chunk_size <= int(2e9 / (784 * 111 * 8)) + 8
    assert ev.chunk_size >= 1024
