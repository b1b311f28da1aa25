"""Tests for the performance tester and PaSR harnesses."""

import os

import numpy as np
import pytest

from pyjac_jax.testers import pasr
from pyjac_jax.testers.functional import fd_jacobian
from pyjac_jax.testers.performance import (check_step_file,
                                           find_mechanisms, pack_data_bin,
                                           performance_tester, step_sizes)


def test_step_sizes():
    assert step_sizes(1020, minimum=256) == [256, 512, 1020]
    assert step_sizes(256, minimum=256) == [256]


def test_pack_data_bin(tmp_path, small_rows):
    rows = small_rows[:7]
    src = tmp_path / 'states.npy'
    np.save(src, rows)
    out = tmp_path / 'data.bin'
    n = pack_data_bin(str(src), str(out))
    assert n == 7
    raw = np.fromfile(out, dtype='<f8').reshape(7, -1)
    np.testing.assert_array_equal(raw, rows)


def test_check_step_file(tmp_path):
    p = tmp_path / 'out.txt'
    p.write_text('256,1.5\n256,1.6\n512,3.0\njunk\n')
    done = check_step_file(str(p), repeats=10)
    assert done == {256: 2, 512: 1}


def test_performance_tester_end_to_end(tmp_path, small_rows):
    """Full sweep on a tiny work dir, then resume skips everything."""
    from pyjac_jax.testers.synthetic import plausible_mechanism
    work = tmp_path / 'work'
    sub = work / 'small'
    os.makedirs(sub)
    (sub / 'small.inp').write_text(plausible_mechanism(12, 30, seed=2))
    np.save(sub / 'states.npy', small_rows[:64])

    found = list(find_mechanisms(str(work)))
    assert len(found) == 1 and found[0][0] == 'small'

    performance_tester(str(work), methods=['ajac'], dtypes=['f64'],
                       repeats=2, steps=[16, 32], verbose=False)
    out = work / 'output' / 'small_ajac_f64_output.txt'
    lines = out.read_text().strip().splitlines()
    assert len(lines) == 4          # 2 sizes x 2 repeats
    assert (sub / 'data.bin').exists()
    ns = sorted(set(int(l.split(',')[0]) for l in lines))
    assert ns == [16, 32]
    for line in lines:
        assert float(line.split(',')[1]) > 0

    # resume: no new lines appended
    performance_tester(str(work), methods=['ajac'], dtypes=['f64'],
                       repeats=2, steps=[16, 32], verbose=False)
    assert len(out.read_text().strip().splitlines()) == 4


def test_fd_jacobian_orders(flagship, flagship_states):
    """Higher-order FD converges toward the analytical Jacobian on PaSR
    states of the flagship mechanism."""
    import jax.numpy as jnp

    from pyjac_jax.ops.jacobian import eval_jacobian
    _, packed = flagship
    y = flagship_states['y'][1000:1004]
    P = flagship_states['P'][1000:1004]
    J = np.asarray(eval_jacobian(packed, 0.0, jnp.asarray(P),
                                 jnp.asarray(y)))
    err = {}
    for order in (1, 6):
        J_fd = fd_jacobian(packed, 0.0, P, y, order=order)
        err[order] = (np.linalg.norm(J - J_fd) / np.linalg.norm(J))
    assert err[6] < err[1]
    assert err[6] < 1e-5


def test_equivalence_ratio(h2o2_mech):
    X = pasr.equivalence_ratio_reactants(h2o2_mech, 1.0, {'H2': 1.0},
                                         {'O2': 1.0, 'N2': 3.76})
    names = h2o2_mech.species_names
    # stoichiometric H2/air: H2:1, O2:0.5, N2:1.88 -> normalize
    total = 1.0 + 0.5 + 1.88
    assert X[names.index('H2')] == pytest.approx(1.0 / total)
    assert X[names.index('O2')] == pytest.approx(0.5 / total)
    assert X[names.index('N2')] == pytest.approx(1.88 / total)


@pytest.mark.slow
def test_pasr_smoke(h2o2_mech):
    """Short PaSR run: shapes, invariants, and a hot pilot."""
    data = pasr.run_simulation(
        h2o2_mech, 'premixed', 300.0, 1.0, 1.0, {'H2': 1.0},
        {'O2': 1.0, 'N2': 3.76}, num_part=4, tau_res=1e-3, tau_mix=5e-4,
        tau_pair=1e-3, num_res=1, seed=0, verbose=False)
    n_steps, n_part, width = data.shape
    assert n_part == 4 and width == 3 + h2o2_mech.n_species
    # adiabatic flame temperature of stoich H2/air ~ 2390 K
    assert 2300 < data[0, :, 1].max() < 2450
    np.testing.assert_allclose(data[:, :, 3:].sum(-1), 1.0, atol=1e-10)
    assert data[:, :, 3:].min() >= -1e-12
    assert np.allclose(data[:, :, 2], 101325.0)


@pytest.mark.slow
def test_pasr_non_premixed(h2o2_mech):
    """Non-premixed case: three inlet streams (air/fuel/pilot)."""
    data = pasr.run_simulation(
        h2o2_mech, 'non-premixed', 300.0, 1.0, 1.0, {'H2': 1.0},
        {'O2': 1.0, 'N2': 3.76}, num_part=4, tau_res=1e-3, tau_mix=5e-4,
        tau_pair=1e-3, num_res=1, seed=1, verbose=False)
    assert data.shape[1] == 4
    np.testing.assert_allclose(data[:, :, 3:].sum(-1), 1.0, atol=1e-9)
    # fuel and air streams keep entering: temperatures span cold and hot
    assert data[:, :, 1].min() < 1500.0
    assert data[:, :, 1].max() > 2200.0


def test_pasr_bad_case(h2o2_mech):
    with pytest.raises(ValueError):
        pasr.run_simulation(h2o2_mech, 'weird', 300.0, 1.0, 1.0,
                            {'H2': 1.0}, {'O2': 1.0, 'N2': 3.76},
                            num_part=2, num_res=1)


@pytest.mark.slow
def test_pasr_statistics_match_reference_fixture(h2o2_mech):
    """Run PaSR with the reference's exact configuration
    (data/pasr_input.yaml: premixed H2/air, phi=1, 300 K, 1 atm,
    10 particles, tau_res 10 ms, tau_mix = tau_pair = 1 ms, 1 residence
    time) and compare state-distribution statistics against the
    reference-toolchain fixture h2_pasr_output.npy (generated with
    Cantera chemistry)."""
    ref = np.load(__import__('tests.conftest', fromlist=['data_path'])
                  .data_path('h2_pasr_output.npy'))
    data = pasr.run_simulation(
        h2o2_mech, 'premixed', 300.0, 1.0, 1.0, {'H2': 1.0},
        {'O2': 1.0, 'N2': 3.76}, num_part=10, tau_res=10e-3,
        tau_mix=1e-3, tau_pair=1e-3, num_res=1, seed=4, verbose=False)
    assert data.shape[1:] == ref.shape[1:]
    assert abs(data.shape[0] - ref.shape[0]) <= 2
    T_ours, T_ref = data[:, :, 1], ref[:, :, 1]
    # pilot/adiabatic-flame ceiling matches within a few K
    assert abs(T_ours.max() - T_ref.max()) < 25.0
    # cold inflow appears in both
    assert T_ours.min() < 900.0 and T_ref.min() < 900.0
    # bulk temperature statistics agree loosely (stochastic process)
    assert abs(T_ours.mean() - T_ref.mean()) / T_ref.mean() < 0.25
    # composition sanity: same species bounds
    np.testing.assert_allclose(data[:, :, 3:].sum(-1), 1.0, atol=1e-9)


def test_pasr_cli_main(h2o2_cti, tmp_path):
    """python -m pyjac_jax.testers.pasr end to end with a YAML input."""
    yaml_text = """case: premixed
temperature: 300.0
pressure: 1.0
equivalence ratio: 1.0
fuel:
  H2: 1.0
oxidizer:
  O2: 1.0
  N2: 3.76
complete products:
  - H2O
  - N2
number of particles: 4
residence time: 0.5e-3
mixing time: 0.25e-3
pairing time: 0.5e-3
number of residence times: 1
"""
    ypath = tmp_path / 'pasr.yaml'
    ypath.write_text(yaml_text)
    out = tmp_path / 'out.npy'
    from pyjac_jax.testers.pasr import main as pasr_main
    rc = pasr_main(['-i', h2o2_cti, '-y', str(ypath), '-o', str(out),
                    '--seed', '0'])
    assert rc == 0
    data = np.load(out)
    assert data.shape[1] == 4 and data.shape[2] == 13


def test_checksum_reduces_every_element():
    """The timing checksum must sum FULL outputs — a strided slice lets
    XLA dead-code-eliminate the rest and fake throughput (ADVICE r1)."""
    import jax.numpy as jnp

    from pyjac_jax.testers.performance import _checksum
    a = jnp.arange(1000, dtype=jnp.float64)
    b = jnp.ones((33, 7), dtype=jnp.float64)
    total = float(_checksum((a, b)))
    assert total == float(jnp.sum(a)) + 33 * 7


def test_timed_eval_matches_bench_methodology(small_packed, small_states):
    """ajac timing must report a throughput consistent (within 4x) with
    an independently-timed full-sum jitted step on the same batch."""
    import time

    import jax
    import jax.numpy as jnp

    from pyjac_jax.ops.jacobian import jacobian_and_dydt
    from pyjac_jax.testers.performance import _timed_eval

    st = small_states
    y, P = st['y'], st['P']
    ms = _timed_eval(small_packed, 'ajac', y, P, 'f64')

    @jax.jit
    def step(p, yy):
        J, f = jacobian_and_dydt(small_packed, 0.0, p, yy)
        return jnp.sum(J) + jnp.sum(f)

    Pj, yj = jnp.asarray(P), jnp.asarray(y)
    float(step(Pj, yj))
    best = min(_time_one(step, Pj, yj) for _ in range(3))
    assert ms <= 4 * best * 1e3 and best * 1e3 <= 4 * ms


def _time_one(step, Pj, yj):
    import time
    t0 = time.perf_counter()
    float(step(Pj, yj))
    return time.perf_counter() - t0


def test_functional_tester_triage_hooks(tmp_path):
    """--only_reaction strips the mechanism; --condition_numbers selects
    states (reference: functional_tester/test.py:1139-1144, :1260-1262)."""
    from pyjac_jax.core.mech import Mechanism
    from pyjac_jax.testers.__main__ import main as ft_main
    from pyjac_jax.testers.synthetic import plausible_mechanism

    mech_path = str(tmp_path / 'small.inp')
    with open(mech_path, 'w') as fh:
        fh.write(plausible_mechanism(12, 30, seed=2))
    mech = Mechanism.from_files(mech_path)
    sub = mech.restrict_reactions([0, 2, 5])
    assert sub.n_reactions == 3
    assert sub.reacs[1] is mech.reacs[2]
    assert sub.n_species == mech.n_species
    import pytest as _pytest
    with _pytest.raises(IndexError):
        mech.restrict_reactions([999])

    out = tmp_path / 'err.npz'
    rc = ft_main(['-i', mech_path, '-n', '4',
                  '--only_reaction', '0,1,2,3',
                  '--condition_numbers', '0,2',
                  '-o', str(out), '--fail-above', '1e-6'])
    assert rc == 0
    import numpy as np
    err = np.load(out)
    assert len(err['err_jac_thr_max']) == 2
