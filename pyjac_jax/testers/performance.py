"""Performance test harness.

Rebuild of the reference's performance tester
(reference: pyjac/performance_tester/performance_tester.py:213-508):

* walks a work directory for mechanism folders containing a mechanism
  file plus PaSR state data (``*.npy``) (reference :241-256),
* packs the state data into a raw-double ``data.bin``
  (reference :316-338) — read back through the native C loader in
  :mod:`pyjac_jax.runtime` when available,
* sweeps an option matrix — Jacobian method {analytical, AD, finite
  difference} x precision {f64, f32} x state count (powers of two up to
  the dataset size, reference :341-347),
* appends ``num_odes,runtime_ms`` lines to per-configuration output
  files, with the reference's resume-by-line-count semantics
  (reference :71-142),
* repeats each configuration (default 10, reference :269-270).

The measured quantity matches the reference drivers: wall-clock for N
fused Jacobian(+dydt) evaluations with a host synchronisation at the end
(reference: tester.c.in:23-31, tester.cu.in:109-156).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

MECH_EXTS = ('.cti', '.inp', '.dat')


@dataclass
class PerfConfig:
    mech_name: str
    method: str       # 'ajac' | 'ad' | 'fd'
    dtype: str        # 'f64' | 'f32'
    num_states: int
    repeats: int = 10

    @property
    def filename(self) -> str:
        return '{}_{}_{}_output.txt'.format(self.mech_name, self.method,
                                            self.dtype)


def find_mechanisms(work_dir: str):
    """Yield (name, mech_path, thermo_path_or_None, data_path) per
    mechanism subfolder (reference :241-256)."""
    for entry in sorted(os.listdir(work_dir)):
        sub = os.path.join(work_dir, entry)
        if not os.path.isdir(sub):
            continue
        mech = None
        thermo = None
        data = None
        for fn in sorted(os.listdir(sub)):
            low = fn.lower()
            if low.endswith('.cti'):
                mech = os.path.join(sub, fn)
            elif low.endswith(('.inp', '.dat')) and mech is None:
                if 'therm' in low:
                    thermo = os.path.join(sub, fn)
                else:
                    mech = os.path.join(sub, fn)
            elif 'therm' in low and low.endswith(('.dat', '.inp')):
                thermo = os.path.join(sub, fn)
            elif low.endswith('.npy'):
                data = os.path.join(sub, fn)
        if mech and data:
            yield entry, mech, thermo, data


def pack_data_bin(npy_path: str, out_path: str) -> int:
    """PaSR .npy -> raw little-endian doubles 'data.bin', rows of
    (t, T, P, Y...) (reference :316-338), written through the native
    runtime. Returns the row count."""
    from ..runtime import stateio
    data = np.load(npy_path)
    data = data.reshape(-1, data.shape[-1])
    stateio.save_raw(out_path, data)
    return data.shape[0]


def check_step_file(path: str, repeats: int) -> dict:
    """Parse an existing output file into {num_odes: runs_completed}
    (reference's resume logic, :71-109)."""
    done = {}
    if not os.path.exists(path):
        return done
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split(',')
            if len(parts) != 2:
                continue
            try:
                n = int(parts[0])
                float(parts[1])
            except ValueError:
                continue
            done[n] = done.get(n, 0) + 1
    return done


def step_sizes(total: int, minimum: int = 256) -> List[int]:
    """Powers of two up to the dataset size (reference :341-347)."""
    steps = []
    n = minimum
    while n < total:
        steps.append(n)
        n *= 2
    steps.append(total)
    return steps


def _timed_eval(packed, method: str, y: np.ndarray, P: np.ndarray,
                dtype: str, best_of: int = 3) -> float:
    """Best-of-N timed pass over the batch; returns wall ms.

    The jitted step reduces its FULL outputs to one scalar (so no part
    of the kernel is DCE-eligible) and each pass ends when that scalar
    reaches the host; the compiling first call is excluded and the best
    of N passes is kept.
    """
    import jax
    import jax.numpy as jnp

    from ..ops.jacobian import jacobian_and_dydt, jacobian_fwd
    from .functional import fd_jacobian

    jdt = jnp.float64 if (dtype == 'f64' and
                          jax.config.jax_enable_x64) else jnp.float32
    yj = jnp.asarray(y, dtype=jdt)
    Pj = jnp.asarray(P, dtype=jdt)

    if method == 'ajac':
        fn = jax.jit(lambda p, yy: _checksum(
            jacobian_and_dydt(packed, 0.0, p, yy)))
    elif method == 'ad':
        fn = jax.jit(lambda p, yy: _checksum(
            (jacobian_fwd(packed, 0.0, p, yy),)))
    elif method == 'fd':
        best = float('inf')
        for _ in range(best_of):
            t0 = time.perf_counter()
            fd_jacobian(packed, 0.0, P, y, order=1)
            best = min(best, time.perf_counter() - t0)
        return best * 1e3
    else:
        raise ValueError(method)

    chk = float(fn(Pj, yj))          # compile + warm
    if not np.isfinite(chk):
        raise RuntimeError('non-finite checksum in %s timing' % method)
    best = float('inf')
    for _ in range(best_of):
        t0 = time.perf_counter()
        float(fn(Pj, yj))            # host sync via scalar transfer
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _checksum(arrays):
    """Reduce EVERY output element to one scalar.

    A strided or sliced reduction would let XLA dead-code-eliminate most
    of the kernel and fake the throughput (see docs/performance.md);
    full sums make every element live while the host transfer stays one
    scalar.
    """
    import jax.numpy as jnp
    total = 0.0
    for a in arrays:
        total = total + jnp.sum(a)
    return total


def performance_tester(work_dir: str, methods: Sequence[str] = ('ajac',),
                       dtypes: Sequence[str] = ('f64',),
                       repeats: int = 10,
                       steps: Optional[Sequence[int]] = None,
                       verbose: bool = True) -> None:
    """Run the sweep; resume-able (reference :213-508)."""
    import jax
    jax.config.update('jax_enable_x64', True)

    from ..core.mech import Mechanism
    from ..core.pack import pack

    out_dir = os.path.join(work_dir, 'output')
    os.makedirs(out_dir, exist_ok=True)

    for name, mech_path, thermo_path, data_path in \
            find_mechanisms(work_dir):
        mech = Mechanism.from_files(mech_path, thermo_path)
        packed = pack(mech)

        bin_path = os.path.join(work_dir, name, 'data.bin')
        pack_data_bin(data_path, bin_path)
        # load + pivot through the native runtime (read_initial_conditions
        # analog)
        from ..runtime import stateio
        raw = stateio.load_raw(bin_path, 3 + packed.n_species)
        y_all, P, _ = stateio.build_states(raw, mech.fwd_spec_mapping)

        sizes = list(steps) if steps else step_sizes(len(y_all))
        for method in methods:
            for dtype in dtypes:
                cfg = PerfConfig(name, method, dtype, 0, repeats)
                out_path = os.path.join(out_dir, cfg.filename)
                done = check_step_file(out_path, repeats)
                with open(out_path, 'a') as fh:
                    for n in sizes:
                        todo = repeats - done.get(n, 0)
                        if todo <= 0:
                            if verbose:
                                print('skip (resume): %s n=%d' %
                                      (cfg.filename, n))
                            continue
                        reps = np.tile(y_all,
                                       (int(np.ceil(n / len(y_all))), 1))
                        yb = reps[:n]
                        Pb = np.tile(P, int(np.ceil(n / len(P))))[:n]
                        for _ in range(todo):
                            ms = _timed_eval(packed, method, yb, Pb,
                                             dtype)
                            fh.write('{},{}\n'.format(n, ms))
                            fh.flush()
                            if verbose:
                                print('%s: %d odes  %.3f ms  '
                                      '(%.0f evals/s)' %
                                      (cfg.filename, n, ms,
                                       n / ms * 1e3))


def main(argv=None) -> int:
    """``python -m pyjac_jax.testers.performance``
    (reference parity: pyjac/performance_tester/__main__.py:7-28)."""
    import argparse
    parser = argparse.ArgumentParser(
        prog='pyjac_jax.testers.performance',
        description='Performance sweep over mechanism folders in a work '
                    'directory (resume-able).')
    parser.add_argument('-w', '--working_dir', required=True,
                        help='Directory with per-mechanism subfolders '
                             '(mechanism file + PaSR .npy).')
    parser.add_argument('-m', '--methods', nargs='+',
                        default=['ajac'],
                        choices=['ajac', 'ad', 'fd'])
    parser.add_argument('-p', '--precisions', nargs='+',
                        default=['f64'], choices=['f64', 'f32'])
    parser.add_argument('-r', '--repeats', type=int, default=10)
    parser.add_argument('-s', '--steps', type=int, nargs='*', default=None)
    args = parser.parse_args(argv)
    from ..compile_cache import enable_compile_cache
    enable_compile_cache()
    performance_tester(args.working_dir, methods=args.methods,
                       dtypes=args.precisions, repeats=args.repeats,
                       steps=args.steps)
    return 0


if __name__ == '__main__':
    import sys
    sys.exit(main())
