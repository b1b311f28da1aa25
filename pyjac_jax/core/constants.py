"""Physical constants and element atomic weights.

Rebuild of the reference's constant tables
(reference: pyjac/core/chem_utilities.py:16-99). Values are kept
bit-identical to the reference so that packed mechanism constants and
all downstream rate evaluations agree to machine precision.
"""

from __future__ import annotations

# Universal gas constant, SI units [J / (kmol K)]
RU = 8314.4621
# Universal gas constant [J / (mol K)]
RU_JOUL = 8.3144621
# Universal gas constant [cal / (mol K)]
RUC = RU / 4.18400

# Avogadro's number [1/mol]
AVAG = 6.0221367e23

# One standard atmosphere [Pa]
PA = 101325.0

# Activation-energy unit -> activation *temperature* [K] conversion factors
# (reference: pyjac/core/mech_interpret.py:42-49). The internal unit for E
# is Kelvin (Ta = E / R).
ACT_ENERGY_FACT = {
    'kelvins': 1.0,
    'evolts': 11595.,
    'cal/mole': 4.184 / RU_JOUL,
    'kcal/mole': 4184. / RU_JOUL,
    'joules/mole': 1. / RU_JOUL,
    'kjoules/mole': 1000.0 / RU_JOUL,
    'joules/kmole': 1. / (RU_JOUL * 1000.),
}

PRE_UNITS = ['moles', 'molecules']
ACT_ENERGY_UNITS = list(ACT_ENERGY_FACT.keys())


def get_elem_wt() -> dict:
    """Element name (lowercase) -> atomic weight [kg/kmol].

    Same table as the reference (pyjac/core/chem_utilities.py:51-99) so
    molecular weights agree exactly.
    """
    return dict([
        ('h', 1.00794), ('he', 4.00260), ('li', 6.93900),
        ('be', 9.01220), ('b', 10.81100), ('c', 12.0110),
        ('n', 14.00674), ('o', 15.99940), ('f', 18.99840),
        ('ne', 20.18300), ('na', 22.98980), ('mg', 24.31200),
        ('al', 26.98150), ('si', 28.08600), ('p', 30.97380),
        ('s', 32.06400), ('cl', 35.45300), ('ar', 39.94800),
        ('k', 39.10200), ('ca', 40.08000), ('sc', 44.95600),
        ('ti', 47.90000), ('v', 50.94200), ('cr', 51.99600),
        ('mn', 54.93800), ('fe', 55.84700), ('co', 58.93320),
        ('ni', 58.71000), ('cu', 63.54000), ('zn', 65.37000),
        ('ga', 69.72000), ('ge', 72.59000), ('as', 74.92160),
        ('se', 78.96000), ('br', 79.90090), ('kr', 83.80000),
        ('rb', 85.47000), ('sr', 87.62000), ('y', 88.90500),
        ('zr', 91.22000), ('nb', 92.90600), ('mo', 95.94000),
        ('tc', 99.00000), ('ru', 101.07000), ('rh', 102.90500),
        ('pd', 106.40000), ('ag', 107.87000), ('cd', 112.40000),
        ('in', 114.82000), ('sn', 118.69000), ('sb', 121.75000),
        ('te', 127.60000), ('i', 126.90440), ('xe', 131.30000),
        ('cs', 132.90500), ('ba', 137.34000), ('la', 138.91000),
        ('ce', 140.12000), ('pr', 140.90700), ('nd', 144.24000),
        ('pm', 145.00000), ('sm', 150.35000), ('eu', 151.96000),
        ('gd', 157.25000), ('tb', 158.92400), ('dy', 162.50000),
        ('ho', 164.93000), ('er', 167.26000), ('tm', 168.93400),
        ('yb', 173.04000), ('lu', 174.99700), ('hf', 178.49000),
        ('ta', 180.94800), ('w', 183.85000), ('re', 186.20000),
        ('os', 190.20000), ('ir', 192.20000), ('pt', 195.09000),
        ('au', 196.96700), ('hg', 200.59000), ('tl', 204.37000),
        ('pb', 207.19000), ('bi', 208.98000), ('po', 210.00000),
        ('at', 210.00000), ('rn', 222.00000), ('fr', 223.00000),
        ('ra', 226.00000), ('ac', 227.00000), ('th', 232.03800),
        ('pa', 231.00000), ('u', 238.03000), ('np', 237.00000),
        ('pu', 242.00000), ('am', 243.00000), ('cm', 247.00000),
        ('bk', 249.00000), ('cf', 251.00000), ('es', 254.00000),
        ('fm', 253.00000), ('d', 2.01410), ('e', 5.48578e-4),
    ])
