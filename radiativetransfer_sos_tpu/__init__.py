"""Successive-orders-of-scattering radiative transfer framework.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
CNES SOS-ABS V5.1 reference (polarized plane-parallel RT with gaseous
absorption via correlated-k distributions, aerosols via Mie theory, and
ocean/land BRDF-BPDF surfaces).
"""

__version__ = "0.5.0"

from . import angles, constants, gsf, kernels, solver  # noqa: F401
