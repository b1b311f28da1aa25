"""Test configuration: force an 8-device virtual CPU mesh with float64.

The parity bar (max rel err <= 1e-8, BASELINE.md) requires f64, and the
multi-chip sharding tests need multiple devices; both are provided by
the host CPU platform with a forced device count. This must run before
any JAX computation.
"""

import os

os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '') +
                           ' --xla_force_host_platform_device_count=8')

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

import pathlib  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
LOCAL_DATA = REPO / 'tests' / 'data'


def data_path(name: str) -> str:
    """A fixture file of tests/data. The H2/O2 mechanism and PaSR files
    of the reference are not shipped with the repository; tests that
    need them skip."""
    p = LOCAL_DATA / name
    if not p.exists():
        pytest.skip('fixture %s not in tests/data' % name)
    return str(p)


def _mech_from_text(tmp_path_factory, name, text):
    from pyjac_jax.core.mech import Mechanism
    path = tmp_path_factory.mktemp(name) / (name + '.inp')
    path.write_text(text)
    return Mechanism.from_files(str(path))


def _state_dict(mech, n, seed, T_range):
    """Random states of ``mech`` as [T, Y_1..Y_{N-1}] plus (T, P,
    Y_full), the layout of the ``h2o2_states`` fixture."""
    from pyjac_jax.testers.synthetic import random_states
    y, T, P = random_states(mech, n, seed=seed, T_range=T_range)
    Y_full = np.concatenate([y[:, 1:], 1.0 - y[:, 1:].sum(1)[:, None]], 1)
    return {'y': y, 'T': T, 'P': P, 'Y_full': Y_full}


@pytest.fixture(scope='session')
def small_mech(tmp_path_factory):
    """In-repo 12-species / 30-reaction mechanism with the GRI-3.0
    category mix (reversible elementary, third-body, Troe/Lindemann
    falloff, a duplicate pair) and thermodynamically consistent,
    time-integrable chemistry (``plausible_mechanism``)."""
    from pyjac_jax.testers.synthetic import plausible_mechanism
    return _mech_from_text(tmp_path_factory, 'small',
                           plausible_mechanism(12, 30, seed=2))


@pytest.fixture(scope='session')
def small_packed(small_mech):
    from pyjac_jax.core.pack import pack
    return pack(small_mech)


@pytest.fixture(scope='session')
def small_states(small_mech):
    return _state_dict(small_mech, 256, seed=11, T_range=(1000.0, 2200.0))


@pytest.fixture(scope='session')
def synth_mech(tmp_path_factory):
    """The 9-species / 24-reaction all-features synthetic mechanism
    (PLOG, Chebyshev, SRI, chemically-activated, fractional orders) of
    ``tests/data/golden_synth_refc.npz``."""
    from pyjac_jax.testers.synthetic import synthetic_mechanism
    return _mech_from_text(tmp_path_factory, 'synth',
                           synthetic_mechanism(n_species=9, n_reactions=24,
                                               seed=7))


@pytest.fixture(scope='session')
def synth_packed(synth_mech):
    from pyjac_jax.core.pack import pack
    return pack(synth_mech)


@pytest.fixture(scope='session')
def h2o2_inp():
    return data_path('h2o2.inp')


@pytest.fixture(scope='session')
def h2o2_cti():
    return data_path('h2o2.cti')


@pytest.fixture(scope='session')
def pasr_states():
    """PaSR fixture states: (n_states, 3 + NSP) = [t, T, P, Y...]."""
    d = np.load(data_path('h2_pasr_output.npy'))
    return d.reshape(-1, d.shape[-1])


@pytest.fixture(scope='session')
def h2o2_mech(h2o2_cti):
    from pyjac_jax.core.mech import Mechanism
    return Mechanism.from_files(h2o2_cti)


@pytest.fixture(scope='session')
def h2o2_packed(h2o2_mech):
    from pyjac_jax.core.pack import pack
    return pack(h2o2_mech)


@pytest.fixture(scope='session')
def h2o2_states(h2o2_mech, pasr_states):
    """Pivoted state vectors [T, Y_1..Y_{N-1}] plus (T, P, Y_full)."""
    d = pasr_states
    T, P = d[:, 1], d[:, 2]
    Yfull = d[:, 3:][:, h2o2_mech.fwd_spec_mapping]
    y = np.concatenate([T[:, None], Yfull[:, :-1]], axis=1)
    return {'y': y, 'T': T, 'P': P, 'Y_full': Yfull}


@pytest.fixture
def gpu_card():
    """Skip unless this machine has an NVIDIA GPU (the tests that use it
    run their work in a fresh process, outside this CPU-pinned one)."""
    import shutil
    if shutil.which('nvidia-smi') is None:
        pytest.skip('no NVIDIA GPU on this machine (nvidia-smi not found)')


@pytest.fixture(scope='session')
def flagship(tmp_path_factory):
    """(mech, packed) of the flagship 53-species / 325-reaction
    ``plausible_mechanism`` (seed 42), the benchmark's mechanism."""
    from pyjac_jax.core.pack import pack
    from pyjac_jax.testers.synthetic import plausible_mechanism
    mech = _mech_from_text(tmp_path_factory, 'flagship',
                           plausible_mechanism(53, 325, seed=42))
    return mech, pack(mech)


@pytest.fixture(scope='session')
def flagship_states():
    """The flagship's PaSR ensemble (tests/data/flagship_states.npz):
    near-equilibrium states, y in internal order, P in Pa."""
    d = np.load(data_path('flagship_states.npz'))
    return {'y': d['y'], 'P': d['P']}


@pytest.fixture(scope='session')
def small_rows(small_mech, small_states):
    """``small_states`` as PaSR-layout rows (t, T, P, Y_full in the
    mechanism file's species order), the reference's data.bin layout."""
    st = small_states
    back = np.asarray(small_mech.back_spec_mapping)
    n = len(st['T'])
    return np.ascontiguousarray(np.concatenate(
        [np.zeros((n, 1)), st['T'][:, None], st['P'][:, None],
         st['Y_full'][:, back]], axis=1))
