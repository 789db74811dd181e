"""Physical constants shared by every qpsim_tpu_torch module (carried over verbatim from qpsim_tpu).

The reference implementation carries two slightly different Boltzmann
constants (``reference qpsim/solver.py:347`` uses 86.17333262145 and
``reference qpsim/initial_conditions.py:20`` uses 86.173303).  This
framework standardises on the CODATA value everywhere.
"""

# Boltzmann constant in micro-eV per Kelvin (CODATA 2018: 8.617333262145e-5 eV/K).
K_B_UEV_PER_K: float = 86.17333262145

# Exponent clip used in Bose/Fermi occupation factors to avoid overflow.
OCCUPATION_EXP_CLIP: float = 500.0

# Numerical floor used when dividing by a density of states.
DOS_FLOOR: float = 1e-30
