"""Physical and computational constants.

Two internally-consistent constant sets coexist, mirroring the reference:

* The SI radiation constants ``C1``/``C2`` used by the Planck /
  brightness-temperature functions (reference: ``radiative_transfer.py:71-72``).
* The CGS set used by the line-by-line engine (reference:
  ``misc/hapi.py:83-92``), including the second radiation constant in
  cm·K (``C2_CM_K``) that HITRAN intensity temperature-scaling uses
  (reference: ``misc/hapi.py:10171``).

The literal values are those of ``radtxfr_tpu.core.constants``, so the port
and the JAX package compute from identical constants.
"""

from __future__ import annotations

# --- SI radiation constants (radiative_transfer.py:71-72) -------------------
#: 1st radiation constant, c1 = 2*h*c^2  [J m^2 / s]
C1 = 1.19104295315e-16
#: 2nd radiation constant, c2 = h*c/k  [m K]
C2 = 1.43877736830e-02

# --- CGS constants for the line-by-line engine (misc/hapi.py:83-92) ---------
#: Boltzmann constant [erg/K]
K_BOLTZMANN_CGS = 1.380648813e-16
#: Speed of light [cm/s]
C_LIGHT_CGS = 2.99792458e10
#: Planck constant [erg s]
H_PLANCK_CGS = 6.626196e-27
#: Atomic mass unit [kg] (misc/hapi.py:11085)
C_MASS_MOL = 1.66053873e-27

#: Second radiation constant in cm K used for HITRAN intensity scaling
#: (misc/hapi.py:10171)
C2_CM_K = 1.4388028496642257

# --- Computational constants (misc/hapi.py:88-92) ---------------------------
SQRT_LN2_DIV_SQRT_PI = 0.469718639319144059835
LN2 = 0.6931471805599
SQRT_LN2 = 0.8325546111577
SQRT_2LN2 = 1.1774100225

# --- Reference thermodynamic state (misc/hapi.py:10988-10989) ---------------
#: HITRAN reference temperature [K]
T_REF = 296.0
#: HITRAN reference pressure [atm]
P_REF = 1.0

# --- Unit conversions -------------------------------------------------------
#: Pa per atm
PA_PER_ATM = 101325.0
#: dyn/cm^2 per atm (misc/hapi.py:10164 uses 1/9.869233e-7)
BARYE_PER_ATM = 1.0 / 9.869233e-7
#: cm per km
CM_PER_KM = 1.0e5
