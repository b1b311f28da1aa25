"""Regenerate the reference-C golden fixtures (tests/data/golden_*.npz).

This is the checked-in provenance for the accuracy bar: it drives the
*reference's own code generator* (a pyJac v1.0.6 checkout, given by
``--reference`` or the ``PYJAC_REFERENCE`` environment variable) over
a mechanism, compiles the emitted C with gcc -O2, evaluates every
intermediate (conc, fwd/rev rates, pres_mod, spec rates, dydt, the
analytical Jacobian) over a set of states, and writes the golden npz —
the analog of the reference's own build-and-compare pipeline
(reference: pyjac/functional_tester/test.py:1146-1186 generate+build,
pyjac/libgen/libgen.py:322 compile).

CONV note: pyJac v1.0.6's CONV codegen emits *uncompilable* C — two
one-token syntax bugs (a missing ', ' in the emitted eval_conc_rho
call, rate_subs.py:2361-2364, and a missing ' + ' in the cv_avg sum,
rate_subs.py:2431). ``--conv`` applies exactly those two token fixes to
the emitted text before compiling; nothing else is modified.

Usage (regenerate + verify the checked-in fixtures):
  python tools/make_golden.py --reference PYJAC --mech PYJAC/data/h2o2.inp \
      --from-golden tests/data/golden_h2o2_refc.npz \
      --out regen.npz --compare tests/data/golden_h2o2_refc.npz
  python tools/make_golden.py --reference PYJAC --synthetic 9,24,7 \
      --from-golden tests/data/golden_synth_refc.npz \
      --out regen_synth.npz --compare tests/data/golden_synth_refc.npz
  python tools/make_golden.py --mech ... --conv --from-golden ... --out ...

``--bench`` instead times N eval_jacob sweeps with the independently
written ~20-line driver (the head-to-head CPU figure in
docs/performance.md).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np


_DRIVER = r'''
#include <stdio.h>
#include <stdlib.h>
#include "header.h"
#include "mechanism.h"
#include "chem_utils.h"
#include "rates.h"
#include "dydt.h"
#include "jacob.h"

int main(int argc, char *argv[]) {
    /* argv: states.bin out.bin n_states */
    FILE *in = fopen(argv[1], "rb");
    FILE *out = fopen(argv[2], "wb");
    int n = atoi(argv[3]);
    for (int i = 0; i < n; ++i) {
        double buf[1 + NSP];            /* T, param, Y_1..Y_{NSP-1} */
        if (fread(buf, sizeof(double), 1 + NSP, in) != (size_t)(1 + NSP))
            return 2;
        double T = buf[0], param = buf[1];
        double y[NSP];
        y[0] = T;
        for (int k = 1; k < NSP; ++k) y[k] = buf[1 + k];
#ifdef CONP
        double y_N, mw_avg, rho, conc[NSP];
        eval_conc(T, param, &y[1], &y_N, &mw_avg, &rho, conc);
        double fwd[FWD_RATES];
#if REV_RATES != 0
        double rev[REV_RATES];
#else
        double rev[1];
#endif
        eval_rxn_rates(T, param, conc, fwd, rev);
#if PRES_MOD_RATES != 0
        double pm[PRES_MOD_RATES];
        get_rxn_pres_mod(T, param, conc, pm);
#else
        double pm[1];
#endif
        double sp[NSP], spN;
        eval_spec_rates(fwd, rev, pm, sp, &spN);
        sp[NSP - 1] = spN;
        double dy[NSP];
        dydt(0.0, param, y, dy);
        double jac[NSP * NSP];
        eval_jacob(0.0, param, y, jac);
        fwrite(conc, sizeof(double), NSP, out);
        fwrite(fwd, sizeof(double), FWD_RATES, out);
#if REV_RATES != 0
        fwrite(rev, sizeof(double), REV_RATES, out);
#endif
#if PRES_MOD_RATES != 0
        fwrite(pm, sizeof(double), PRES_MOD_RATES, out);
#endif
        fwrite(sp, sizeof(double), NSP, out);
        fwrite(dy, sizeof(double), NSP, out);
        fwrite(jac, sizeof(double), NSP * NSP, out);
#else  /* CONV: param is density; the reference Jacobian is CONP-only */
        double dy[NSP];
        dydt(0.0, param, y, dy);
        fwrite(dy, sizeof(double), NSP, out);
#endif
    }
    fclose(in);
    fclose(out);
    return 0;
}
'''

_BENCH_DRIVER = r'''
#define _POSIX_C_SOURCE 199309L    /* clock_gettime under -std=c99 */
#include <stdio.h>
#include <stdlib.h>
#include <time.h>
#include "header.h"
#include "mechanism.h"
#include "jacob.h"

int main(int argc, char *argv[]) {
    /* argv: states.bin n_states repeats */
    FILE *in = fopen(argv[1], "rb");
    int n = atoi(argv[2]), reps = atoi(argv[3]);
    double *st = malloc(sizeof(double) * (1 + NSP) * n);
    fread(st, sizeof(double), (size_t)(1 + NSP) * n, in);
    fclose(in);
    double *jac = malloc(sizeof(double) * NSP * NSP);
    double acc = 0.0;
    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (int r = 0; r < reps; ++r)
        for (int i = 0; i < n; ++i) {
            double *b = st + (size_t)(1 + NSP) * i;
            double y[NSP];
            y[0] = b[0];
            for (int k = 1; k < NSP; ++k) y[k] = b[1 + k];
            eval_jacob(0.0, b[1], y, jac);
            acc += jac[0];
        }
    clock_gettime(CLOCK_MONOTONIC, &t1);
    double s = (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
    printf("%d evals in %.3f s -> %.0f evals/s (acc %.3e)\n",
           n * reps, s, n * reps / s, acc);
    return 0;
}
'''


def _fix_netzero_reactions(build_dir):
    """Fix the reference codegen's empty-sum emission for reversible
    reactions with net-zero stoichiometry (reactants == products, e.g.
    an energy-transfer collision channel).  pyJac v1.0.6 emits the
    ``sum(nu_k * B_k)`` / ``sum(nu_k * dBdT_k)`` joins unguarded
    (rate_subs.py:744-766 Kc sum, create_jacobian.py:786-805 dBdT sum),
    so a net-zero reaction produces

    * ``Kc = <coef> * exp(Kc);`` with **no prior Kc assignment** in the
      reaction block — silently reuses the previous reaction's Kc
      (wrong value, compiles), and
    * ``rev_rates[i] * (-1.0 + )) * rho_inv;`` in the Jacobian dT
      partial — an empty sum AND a dropped closing paren (does not
      compile).

    The correct empty-sum value is 0 (Kc == coef * exp(0), dBdT sum
    == 0), and such a reaction contributes nothing to spec_rates/jac —
    the reference's own spec_rates.c emits an empty block for it.
    Token-level fixes only; nothing else is modified."""
    import re
    for root, _dirs, files in os.walk(build_dir):
        for f in files:
            if not f.endswith('.c'):
                continue
            p = os.path.join(root, f)
            txt = open(p).read()
            fixed = txt
            # (a) empty dBdT sum + dropped paren in the jacob dT term
            fixed = fixed.replace('(-1.0 + )) * rho_inv;',
                                  '(-1.0 + 0.0))) * rho_inv;')
            # (b) exp(Kc) with no Kc sum assigned in the same reaction
            # block: the block runs from '//rxn N' (or '//partial of
            # rxn N') to the next such marker
            blocks = re.split(r'(//(?:partial of )?rxn \d+)', fixed)
            for i in range(2, len(blocks), 2):
                body = blocks[i]
                cut = body.find('exp(Kc)')
                if cut != -1 and 'Kc = (' not in body[:cut] \
                        and 'Kc += ' not in body[:cut]:
                    blocks[i] = body.replace('exp(Kc)', 'exp(0.0)', 1)
            fixed = ''.join(blocks)
            if fixed != txt:
                open(p, 'w').write(fixed)


def generate_reference_c(reference, mech, therm, build_dir, conv=False):
    """Run the codegen of the pyJac checkout ``reference``; apply the
    two documented one-token CONV syntax fixes to the emitted text."""
    sys.path.insert(0, reference)
    from pyjac.core.create_jacobian import create_jacobian
    os.makedirs(build_dir, exist_ok=True)
    create_jacobian(lang='c', mech_name=mech, therm_name=therm,
                    build_path=build_dir + '/', optimize_cache=False,
                    auto_diff=False)
    _fix_netzero_reactions(build_dir)
    if conv:
        hdr = os.path.join(build_dir, 'header.h')
        txt = open(hdr).read()
        txt = txt.replace('#define CONP\n//#define CONV',
                          '//#define CONP\n#define CONV')
        open(hdr, 'w').write(txt)
        dy = os.path.join(build_dir, 'dydt.c')
        txt = open(dy).read()
        fixed = txt.replace('eval_conc_rho (y[0]rho,',
                            'eval_conc_rho (y[0], rho,')
        # missing ' + ' before the wrapped last cv_avg term
        import re
        fixed = re.sub(r'(\(cv\[\d+\] \* y\[\d+\]\))(\(cv\[\d+\] \* y_N\))',
                       r'\1 + \2', fixed)
        if fixed == txt:
            raise RuntimeError('CONV syntax fixes did not apply — '
                               'emitted text changed?')
        open(dy, 'w').write(fixed)


def compile_driver(build_dir, driver_src, exe):
    drv = os.path.join(build_dir, 'driver.c')
    open(drv, 'w').write(driver_src)
    srcs = [os.path.join(build_dir, f) for f in os.listdir(build_dir)
            if f.endswith('.c') and f != 'driver.c']
    # mechanisms past the unroll caps emit split subfiles under
    # jacobs/ and rates/ (reference: create_jacobian.py:2213-2221,
    # libgen.py:256-319 reads the jac_list_*/rate_list_* manifests)
    for sub in ('jacobs', 'rates'):
        d = os.path.join(build_dir, sub)
        if os.path.isdir(d):
            srcs += [os.path.join(d, f) for f in sorted(os.listdir(d))
                     if f.endswith('.c')]
    cmd = ['gcc', '-O2', '-std=c99', '-I', build_dir, drv] + srcs + \
        ['-lm', '-o', exe]
    subprocess.run(cmd, check=True)


def load_states(args, n_sp):
    """(T, param, y) in the reference's (pivoted) species order."""
    if args.from_golden:
        g = np.load(args.from_golden)
        T = g['T'] if 'T' in g else g['y'][:, 0]
        if args.conv:
            param = g['rho']         # CONV fixtures may carry P too
        else:
            param = g['P']
        extra = {k: np.asarray(g[k]) for k in g.files
                 if not k.startswith('ref_') and k not in ('T', 'y')}
        return np.asarray(T), np.asarray(param), np.asarray(g['y']), extra
    if args.states_npz:
        # states cached by tools/make_bench_states.py: y is (B, N) with
        # y[:, 0] = T already in the pivoted order (for mechanisms
        # without an N2/Ar/He bath species both this repo and the
        # reference pivot the final file species, so the orders agree
        # and y passes through — create_jacobian.py:3503-3542)
        d = np.load(args.states_npz)
        y = np.asarray(d['y'], np.float64)
        param = np.asarray(d['P'], np.float64)
        if args.num_states:
            idx = np.linspace(0, len(y) - 1, args.num_states).astype(int)
            y, param = y[idx], param[idx]
        return y[:, 0], param, y, {}
    if args.pasr:
        d = np.load(args.pasr).reshape(-1, 3 + n_sp)
        if args.num_states:
            idx = np.linspace(0, len(d) - 1, args.num_states).astype(int)
            d = d[idx]
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        from pyjac_jax.core.mech import Mechanism
        mech = Mechanism.from_files(args.mech, args.therm)
        Y = d[:, 3:][:, mech.fwd_spec_mapping]
        y = np.concatenate([d[:, 1:2], Y[:, :-1]], axis=1)
        return d[:, 1], d[:, 2], y, {}
    raise SystemExit('need --from-golden or --pasr for states')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--reference',
                    default=os.environ.get('PYJAC_REFERENCE'),
                    help='pyJac v1.0.6 checkout whose code generator '
                         'produces the golden (default: $PYJAC_REFERENCE)')
    ap.add_argument('--mech', help='mechanism file (.inp/.dat)')
    ap.add_argument('--therm', default=None)
    ap.add_argument('--synthetic', default=None,
                    help='n_species,n_reactions,seed — regenerate the '
                         'synthetic mechanism instead of --mech')
    ap.add_argument('--plausible', default=None,
                    help='n_species,n_reactions,seed — regenerate the '
                         'thermodynamically-consistent flagship '
                         'mechanism (testers.synthetic.'
                         'plausible_mechanism) instead of --mech')
    ap.add_argument('--from-golden', dest='from_golden', default=None,
                    help='reuse the states stored in an existing golden '
                         'npz (for bit-identical regeneration)')
    ap.add_argument('--pasr', default=None,
                    help='PaSR dump .npy [t, T, P, Y...] for new states')
    ap.add_argument('--states-npz', dest='states_npz', default=None,
                    help='bench-state cache npz with y=(B,N) incl T '
                         'col 0 (pivoted order) and P=(B,)')
    ap.add_argument('--num-states', dest='num_states', type=int,
                    default=None)
    ap.add_argument('--conv', action='store_true')
    ap.add_argument('--out', required=False)
    ap.add_argument('--compare', default=None,
                    help='existing npz to check bit-identity against')
    ap.add_argument('--bench', action='store_true',
                    help='time eval_jacob sweeps instead of dumping')
    ap.add_argument('--repeats', type=int, default=20)
    ap.add_argument('--keep', default=None,
                    help='keep the build directory at this path')
    args = ap.parse_args(argv)
    if not args.reference:
        ap.error('--reference (or PYJAC_REFERENCE) is required')

    tmp = args.keep or tempfile.mkdtemp(prefix='refc_')
    mech = args.mech
    if args.synthetic or args.plausible:
        spec = args.synthetic or args.plausible
        ns, nr, seed = (int(x) for x in spec.split(','))
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        from pyjac_jax.testers.synthetic import (plausible_mechanism,
                                                 synthetic_mechanism)
        gen = plausible_mechanism if args.plausible else \
            synthetic_mechanism
        mech = os.path.join(tmp, 'synth.inp')
        os.makedirs(tmp, exist_ok=True)
        open(mech, 'w').write(gen(
            n_species=ns, n_reactions=nr, seed=seed))
        args.mech = mech

    build = os.path.join(tmp, 'out')
    generate_reference_c(args.reference, mech, args.therm, build,
                         conv=args.conv)

    # sizes from the emitted header
    hdr = open(os.path.join(build, 'mechanism.h')).read()

    def define(name):
        for ln in hdr.splitlines():
            if ln.startswith('#define %s ' % name):
                return int(ln.split()[2])
        return 0

    nsp = define('NSP')
    nfwd = define('FWD_RATES')
    nrev = define('REV_RATES')
    npm = define('PRES_MOD_RATES')

    T, param, y, extra = load_states(args, nsp)
    n = len(T)
    states = np.concatenate([T[:, None].astype(np.float64),
                             np.asarray(param, np.float64)[:, None],
                             np.asarray(y, np.float64)[:, 1:]], axis=1)
    sbin = os.path.join(tmp, 'states.bin')
    states.tofile(sbin)

    exe = os.path.join(tmp, 'bench' if args.bench else 'dump')
    compile_driver(build, _BENCH_DRIVER if args.bench else _DRIVER, exe)

    if args.bench:
        out = subprocess.run([exe, sbin, str(n), str(args.repeats)],
                             check=True, capture_output=True, text=True)
        print(out.stdout.strip())
        return 0

    obin = os.path.join(tmp, 'out.bin')
    subprocess.run([exe, sbin, obin, str(n)], check=True)
    raw = np.fromfile(obin, dtype=np.float64)
    if args.conv:
        rec = raw.reshape(n, nsp)
        result = dict(extra)
        result.update({'T': np.asarray(T), 'rho': np.asarray(param),
                       'y': np.asarray(y), 'ref_dydt': rec})
    else:
        w = nsp + nfwd + nrev + npm + nsp + nsp + nsp * nsp
        rec = raw.reshape(n, w)
        o = 0
        result = {'T': T, 'P': np.asarray(param), 'y': np.asarray(y)}
        for key, width in (('ref_conc', nsp), ('ref_fwd', nfwd),
                           ('ref_rev', nrev), ('ref_pres_mod', npm),
                           ('ref_spec_rates', nsp), ('ref_dydt', nsp),
                           ('ref_jac', nsp * nsp)):
            result[key] = rec[:, o:o + width]
            o += width

    if args.out:
        np.savez(args.out, **result)
        print('wrote %s (%d states)' % (args.out, n))

    if args.compare:
        ref = np.load(args.compare)
        # fixture key aliases (the synth golden abbreviates some names)
        alias = {'ref_pm': 'ref_pres_mod', 'ref_sp': 'ref_spec_rates'}
        ok = True
        for k in ref.files:
            kk = alias.get(k, k)
            if kk not in result:
                print('MISSING key %s' % k)
                ok = False
                continue
            a, b = np.asarray(result[kk]), ref[k]
            if a.shape != b.shape or not np.array_equal(a, b):
                nbad = int((a != b).sum()) if a.shape == b.shape else -1
                mx = np.abs(a - b).max() if a.shape == b.shape else np.nan
                print('MISMATCH %s: shapes %s vs %s, %d differing, '
                      'max abs diff %.3e' % (k, a.shape, b.shape, nbad,
                                             mx))
                ok = False
            else:
                print('IDENTICAL %s %s' % (k, b.shape))
        print('BIT-IDENTICAL' if ok else 'DIFFERS')
        return 0 if ok else 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
