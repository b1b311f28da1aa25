"""Import smoke tests and version check.

Mirrors the reference's CI-run test strategy — import-only assertions
per module plus a semantic-version parse
(reference: pyjac/tests/test_core.py:14-60, tests/test_version.py:12).
"""

import importlib
import re

import pytest

MODULES = [
    'pyjac_jax',
    'pyjac_jax.cli',
    'pyjac_jax.compile_cache',
    'pyjac_jax.integrate',
    'pyjac_jax.libgen',
    'pyjac_jax.profiling',
    'pyjac_jax.utils',
    'pyjac_jax.core.chemkin',
    'pyjac_jax.core.constants',
    'pyjac_jax.core.cti',
    'pyjac_jax.core.ctml',
    'pyjac_jax.core.ctyaml',
    'pyjac_jax.core.ir',
    'pyjac_jax.core.mech',
    'pyjac_jax.core.pack',
    'pyjac_jax.ops.common',
    'pyjac_jax.ops.dydt',
    'pyjac_jax.ops.jacobian',
    'pyjac_jax.ops.rates',
    'pyjac_jax.ops.sparse',
    'pyjac_jax.ops.thermo',
    'pyjac_jax.parallel.mesh',
    'pyjac_jax.runtime.stateio',
    'pyjac_jax.testers.functional',
    'pyjac_jax.testers.numpy_oracle',
    'pyjac_jax.testers.pasr',
    'pyjac_jax.testers.performance',
    'pyjac_jax.testers.synthetic',
]


@pytest.mark.parametrize('name', MODULES)
def test_importable(name):
    assert importlib.import_module(name) is not None


def test_import_has_no_pallas_dependency():
    """Importing the package pulls in no Pallas module."""
    import subprocess
    import sys
    code = ('import sys, pyjac_jax; '
            'print(any("pallas" in m for m in sys.modules))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'False'


def test_version_semver():
    import pyjac_jax
    assert re.match(r'^\d+\.\d+\.\d+', pyjac_jax.__version__)


def test_public_api_complete():
    import pyjac_jax
    for name in pyjac_jax.__all__:
        assert hasattr(pyjac_jax, name), name


def test_common_helpers():
    import jax.numpy as jnp
    import numpy as np

    from pyjac_jax.ops.common import int_pow, safe_log, safe_log10
    c = jnp.asarray([0.0, 1.0, 4.0])
    np.testing.assert_allclose(np.asarray(int_pow(c, 3)), [0., 1., 64.])
    np.testing.assert_allclose(np.asarray(int_pow(c, 0)), [1., 1., 1.])
    assert np.isfinite(np.asarray(safe_log10(c))).all()
    assert np.isfinite(np.asarray(safe_log(c))).all()
