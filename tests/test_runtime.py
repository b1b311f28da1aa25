"""Native state-IO runtime tests (stateio.cpp via ctypes)."""

import numpy as np
import pytest

from pyjac_jax.runtime import stateio


@pytest.fixture(scope='module')
def raw_rows(small_rows):
    return np.ascontiguousarray(small_rows[:200])


def test_native_build():
    assert stateio.native_available(), \
        'native stateio failed to build (g++ expected in this image)'


def test_save_load_roundtrip(tmp_path, raw_rows):
    path = str(tmp_path / 'data.bin')
    stateio.save_raw(path, raw_rows)
    back = stateio.load_raw(path, raw_rows.shape[1])
    np.testing.assert_array_equal(back, raw_rows)
    # partial read
    part = stateio.load_raw(path, raw_rows.shape[1], max_rows=10)
    np.testing.assert_array_equal(part, raw_rows[:10])


def test_build_states_matches_python(small_mech, raw_rows):
    y, P, t = stateio.build_states(raw_rows, small_mech.fwd_spec_mapping)
    fwd = np.asarray(small_mech.fwd_spec_mapping)
    expect_y = np.concatenate(
        [raw_rows[:, 1:2], raw_rows[:, 3:][:, fwd[:-1]]], axis=1)
    np.testing.assert_array_equal(y, expect_y)
    np.testing.assert_array_equal(P, raw_rows[:, 2])
    np.testing.assert_array_equal(t, raw_rows[:, 0])


def test_transpose(raw_rows):
    soa = stateio.to_soa(raw_rows)
    np.testing.assert_array_equal(soa, raw_rows.T)


def test_density_matches_kernels(small_packed, small_states):
    import jax.numpy as jnp

    from pyjac_jax.ops.thermo import eval_conc
    st = small_states
    rho = stateio.density(st['T'], st['P'], st['Y_full'],
                          np.asarray(small_packed.mw))
    _, _, rho_j, _ = eval_conc(small_packed, jnp.asarray(st['T']),
                               jnp.asarray(st['P']),
                               jnp.asarray(st['Y_full'][:, :-1]))
    np.testing.assert_allclose(rho, np.asarray(rho_j), rtol=1e-13)


def test_missing_file():
    with pytest.raises(IOError):
        stateio.load_raw('/nonexistent/data.bin', 13)
