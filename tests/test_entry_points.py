"""The GPU entry points (chip_smoke.py, bench.py) refuse to run without
a GPU, and the smoke test's own checks work."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


@pytest.mark.parametrize('argv', [[], ['--cards', '4']])
def test_chip_smoke_needs_gpu(argv, capsys):
    """On the CPU (conftest pins it) main() fails and prints no result."""
    assert chip_smoke.main(argv) != 0
    out, err = capsys.readouterr()
    assert out == '' and 'needs' in err


def test_bench_needs_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
    assert 'no GPU' in str(exc.value.code)
    assert capsys.readouterr().out == ''


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the
    repository, the script exits non-zero and prints no JSON."""
    shutil.copy(REPO / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_gates_fail_on_nan_and_excess():
    g = chip_smoke.Gates()
    g.check('fine', 1e-12, 1e-10)
    g.check('nan', float('nan'), 1e-10)
    g.check('excess', 2e-8, 1e-8)
    assert g.failed == ['nan', 'excess']
    with pytest.raises(chip_smoke.GateFailure):
        g.close('phase')


def test_error_metrics():
    b = np.array([[1.0, 1e-12, -2.0], [4.0, 0.0, 1.0]])
    a = b.copy()
    a[0, 1] += 1e-20                 # below the floor: floored
    a[1, 2] += 4e-9
    assert chip_smoke.norm_rel(a, b) == pytest.approx(1e-9)
    assert chip_smoke.floored_max_rel(a, b, 1e-10) == pytest.approx(4e-9)
    assert chip_smoke.floored_max_rel(b, b, 1e-10) == 0.0


@pytest.mark.parametrize('dtype,found', [(jnp.float32, True),
                                         (jnp.float64, False)])
def test_f32_matmul_scan(dtype, found):
    """The precision scan finds an f32 matrix product in a compiled
    program and none in an f64 one."""
    x = jnp.ones((16, 16), dtype)
    compiled = jax.jit(lambda a: a @ a).lower(x).compile()
    assert bool(chip_smoke.f32_dots(compiled)) is found


def test_bench_states_tiles_the_ensemble():
    y, P = bench.bench_states(10000)
    d = np.load(bench.STATES)
    n = len(d['y'])
    assert y.shape == (10000, d['y'].shape[1]) and P.shape == (10000,)
    assert y.dtype == P.dtype == np.float64
    np.testing.assert_array_equal(y[n:2 * n], d['y'])
    np.testing.assert_array_equal(P[:n], d['P'])


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_card):
    """The whole smoke test on the card, in a fresh process (this one
    is pinned to the CPU)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ('JAX_PLATFORMS', 'XLA_FLAGS')}
    res = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                         capture_output=True, text=True, env=env,
                         timeout=1200)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last['ok'] is True and last['device']['platform'] == 'gpu'
