"""Ahead-of-time kernel library generation (the ``libgen`` analog).

The reference compiles its generated C/CUDA into ``lib*_pyjac`` archives
(reference: pyjac/libgen/libgen.py:322-411); the equivalent here
exports the jitted mechanism-specialised kernels as serialized StableHLO
artifacts via ``jax.export`` — with a *symbolic batch dimension*, so one
artifact serves any state count — plus a JSON manifest. Artifacts are
loadable without the mechanism file or parser (``load_library``), the
moral equivalent of linking against the reference's compiled library.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional

_KERNELS = ('dydt', 'jacobian', 'jacobian_and_dydt', 'rates')


def _kernel_fn(packed, name: str, conp: bool):
    from .ops import rates as rates_mod
    from .ops import thermo as thermo_mod
    from .ops.dydt import dydt as dydt_fn
    from .ops.jacobian import eval_jacobian, jacobian_and_dydt

    if name == 'dydt':
        return lambda p, y: dydt_fn(packed, 0.0, p, y, conp=conp)
    if name == 'jacobian':
        return lambda p, y: eval_jacobian(packed, 0.0, p, y, conp=conp)
    if name == 'jacobian_and_dydt':
        return lambda p, y: jacobian_and_dydt(packed, 0.0, p, y, conp=conp)
    if name == 'rates':
        def fn(p, y):
            T = y[..., 0]
            if conp:
                # p is pressure [Pa]
                _, _, _, conc = thermo_mod.eval_conc(packed, T, p,
                                                     y[..., 1:])
                pres = p
            else:
                # p is density [kg/m^3]; recover pressure from the state
                _, _, pres, conc = thermo_mod.eval_conc_rho(packed, T, p,
                                                            y[..., 1:])
            fwd, rev = rates_mod.eval_rxn_rates(packed, T, pres, conc)
            pm = rates_mod.get_rxn_pres_mod(packed, T, pres, conc)
            return fwd, rev, pm
        return fn
    raise ValueError('unknown kernel ' + name)


def generate_library(packed, out_dir: str,
                     kernels: Iterable[str] = _KERNELS,
                     conp: bool = True,
                     platforms: Optional[Iterable[str]] = None,
                     dtype: str = 'f64') -> str:
    """Export AOT artifacts for the given kernels into ``out_dir``.

    Returns the manifest path. ``platforms`` defaults to the current
    backend; pass e.g. ``('cpu', 'cuda')`` for an artifact that runs on
    both the CPU and an NVIDIA GPU (``'cuda'`` is JAX's export platform
    name for the GPU).
    """
    import jax
    from jax import export
    import jax.numpy as jnp

    jdt = jnp.float64 if (dtype == 'f64' and jax.config.jax_enable_x64) \
        else jnp.float32
    N = packed.n_species
    os.makedirs(out_dir, exist_ok=True)

    B = export.symbolic_shape('b')[0]
    args = (jax.ShapeDtypeStruct((B,), jdt),
            jax.ShapeDtypeStruct((B, N), jdt))

    kwargs = {} if platforms is None else {'platforms': tuple(platforms)}
    entries = {}
    for name in kernels:
        fn = jax.jit(_kernel_fn(packed, name, conp))
        exp = export.export(fn, **kwargs)(*args)
        blob = exp.serialize()
        fname = '{}_{}.jaxexport'.format(name, 'conp' if conp else 'conv')
        with open(os.path.join(out_dir, fname), 'wb') as fh:
            fh.write(blob)
        entries[name] = fname

    manifest = {
        'format': 'jax.export/stablehlo',
        'n_species': N,
        'n_reactions': packed.n_reactions,
        'species': packed.species_names,
        'conp': conp,
        'dtype': dtype,
        'state_layout': '[T, Y_1..Y_{N-1}]',
        'param': 'pressure [Pa]' if conp else 'density [kg/m^3]',
        'kernels': entries,
    }
    man_path = os.path.join(out_dir, 'library.json')
    with open(man_path, 'w') as fh:
        json.dump(manifest, fh, indent=2)
    return man_path


def load_library(out_dir: str) -> Dict[str, object]:
    """Load exported kernels; returns {'manifest': ..., '<kernel>': fn}.

    The callables take ``(param, y)`` exactly like the live kernels but
    run the serialized AOT program — no mechanism file, parser, or
    packing involved.
    """
    from jax import export

    with open(os.path.join(out_dir, 'library.json')) as fh:
        manifest = json.load(fh)
    out = {'manifest': manifest}
    for name, fname in manifest['kernels'].items():
        with open(os.path.join(out_dir, fname), 'rb') as fh:
            exp = export.deserialize(fh.read())
        out[name] = exp.call
    return out
