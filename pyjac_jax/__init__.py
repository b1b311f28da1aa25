"""pyjac_jax — analytical-Jacobian chemical kinetics in JAX.

A ground-up JAX/XLA rebuild of the capabilities of pyJac (an
ahead-of-time C/CUDA code generator for chemical-kinetics right-hand
sides and analytical Jacobians): parse a Chemkin or Cantera-CTI
mechanism, pack it into constant tensors, and evaluate thermodynamic
properties, reaction rates, dy/dt, and the dense analytical Jacobian as
batched, jit-compiled kernels over thermochemical states.

Quick start::

    import pyjac_jax as pj

    mech = pj.Mechanism.from_files('mech.inp', 'therm.dat')
    packed = pj.pack(mech)
    # y = [T, Y_1..Y_{N-1}] with arbitrary leading batch dims
    f = pj.dydt(packed, 0.0, pressure, y)           # (..., N)
    J = pj.eval_jacobian(packed, 0.0, pressure, y)  # (..., N, N)

The reference implementation this mirrors is SLACKHA/pyJac v1.0.6;
docstrings throughout cite the corresponding reference files/lines.
"""

from .core.chemkin import MechanismError, read_mech, read_thermo
from .integrate import (IntegrateResult, ignition_delay,  # noqa: F401
                        integrate)
from .core.cti import read_mech_cti
from .core.ir import Reaction, Species
from .core.mech import Mechanism, get_species_mappings
from .core.pack import PackedMechanism, pack
from .ops.dydt import dydt, dydt_conp, dydt_conv, split_state
from .ops.jacobian import (eval_jacobian, jacobian_fwd,
                           jacobian_vector_product)
from .ops.sparse import (csr_structure, sparse_values,  # noqa: F401
                         structural_sparsity)
from .ops.rates import (compact_pres_mod, compact_rev, eval_kc, eval_kf,
                        eval_rxn_rates, eval_spec_rates, get_rxn_pres_mod,
                        rates_of_progress, third_body_concentrations)
from .ops.thermo import (eval_conc, eval_conc_rho, eval_cp, eval_cv,
                         eval_h, eval_smh, eval_u)

__version__ = '0.1.0'

__all__ = [
    'Mechanism', 'MechanismError', 'PackedMechanism', 'Reaction',
    'Species', 'compact_pres_mod', 'compact_rev', 'dydt', 'dydt_conp',
    'dydt_conv', 'eval_conc', 'eval_conc_rho', 'eval_cp', 'eval_cv',
    'eval_h', 'eval_jacobian', 'eval_kc', 'eval_kf', 'eval_rxn_rates',
    'eval_smh', 'eval_spec_rates', 'eval_u', 'get_rxn_pres_mod',
    'get_species_mappings', 'ignition_delay', 'integrate',
    'jacobian_fwd', 'jacobian_vector_product',
    'pack', 'rates_of_progress', 'read_mech', 'read_mech_cti',
    'read_thermo', 'split_state', 'third_body_concentrations',
    'structural_sparsity', 'csr_structure', 'sparse_values',
]
