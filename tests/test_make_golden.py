"""Golden-fixture provenance: tools/make_golden.py must regenerate the
checked-in reference-C fixtures bit-identically (reference pipeline
analog: functional_tester/test.py:1146-1186 + libgen.py:322).

Needs a pyJac v1.0.6 checkout, named by the ``PYJAC_REFERENCE``
environment variable, and gcc.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def reference():
    ref = os.environ.get('PYJAC_REFERENCE')
    if not ref or not shutil.which('gcc'):
        pytest.skip('PYJAC_REFERENCE (a pyJac checkout) or gcc unavailable')
    return pathlib.Path(ref)


@pytest.mark.slow
@pytest.mark.parametrize('args,fixture', [
    (['--mech', 'data/h2o2.inp'], 'golden_h2o2_refc.npz'),
    (['--mech', 'data/h2o2.inp', '--conv'], 'golden_h2o2_refc_conv.npz'),
    (['--synthetic', '9,24,7'], 'golden_synth_refc.npz'),
])
def test_golden_regenerates_bit_identical(reference, args, fixture,
                                          tmp_path):
    if args[0] == '--mech':
        args = ['--mech', str(reference / args[1])] + args[2:]
    fx = REPO / 'tests' / 'data' / fixture
    out = tmp_path / 'regen.npz'
    res = subprocess.run(
        [sys.executable, str(REPO / 'tools' / 'make_golden.py'),
         '--reference', str(reference),
         '--from-golden', str(fx), '--out', str(out),
         '--compare', str(fx)] + args,
        capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    assert 'BIT-IDENTICAL' in res.stdout
