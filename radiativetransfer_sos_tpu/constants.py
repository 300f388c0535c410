"""Physical and dimensioning constants of the SOS-ABS successive-orders framework.

Re-design of the reference constant header ``inc/SOS.h`` (561 lines
of cpp ``#define``; see reference ``inc/SOS.h:46-561``).  Only *semantic*
constants live here (physics thresholds, defaults, spectral domain).  Array
dimensioning constants of the Fortran reference (``CTE_OS_NBMU_MAX`` etc.) are
deliberately absent: the JAX implementation compiles to the *actual* problem
shapes, padding only where the solver's layout wants it.
"""

from __future__ import annotations

# --- Spectral validity domain (µm)                       [inc/SOS.h:70-71]
WAMIN = 0.364
WAMAX = 4.0

# --- Sentinel for "unset" parameters                     [inc/SOS.h:76-78]
NOT_DEFINED_INT = -999
NOT_DEFINED_DBLE = -999.0

# --- Mie kernel                                          [inc/SOS.h:96-134]
MIE_DIM = 10000               # max series order
MIE_ALPHAMIN = 1.0e-4         # smallest size parameter of the alpha sweep
DEFAULT_AER_JUNGE_RMAX = 50.0
ALPHAMAX_WMO_DL = 4000.0
ALPHAMAX_WMO_WS = 50.0
ALPHAMAX_WMO_OC = 800.0
ALPHAMAX_WMO_SO = 10.0
ALPHAMAX_SF_SR = 70.0
ALPHAMAX_SF_SU = 90.0
COEF_NRMAX = 1.0e-4           # n(r)/Nmax ratio bounding the alpha sweep

# --- Phase-function truncation                           [inc/SOS.h:162-172]
AER_MU1_TRONCA = 0.8
AER_MU2_TRONCA = 0.94
PH_SEUIL_TRONCA = 0.1         # truncation auto-cancel threshold

MAX_NB_MODE_MIXTURE = 20      # [inc/SOS.h:178]
GAP_TOLER_SUM_RATES = 1.0e-6  # [inc/SOS.h:184]

# --- Atmospheric profile                                 [inc/SOS.h:187-301]
HT_STD_PSURF = 1013.0         # standard surface pressure (hPa)
TOA_ALT = 120.0               # top-of-atmosphere altitude (km)
OS_NT = 600                   # max number of optical-depth layers
TCOUCHE = 0.005               # max layer optical thickness
TOA_FIRST_LAYER_OPT_THICKNESS = 2.0e-4
DELTA_Z = 0.05                # altitude search step (km)
THRESHOLD_DZ = 0.001          # altitude comparison threshold (km)
OS_NT_MIN = 100               # min number of layers
PROFIL_MIN_NBC = 3
DZTRANSI = 0.010              # transition layer thickness (km)

NBABS = 8                     # number of absorbing gases (H2O CO2 O3 N2O CO CH4 O2 NO2)
ABS_NBLEV = 50                # levels of the gas profiles
ABS_NBCOL = 13

# CKD table dimensions                                    [inc/SOS.h:278-292]
CKD_NWVL_MAX = 50
CKD_NAI_MAX = 5
CKD_NT_MAX = 9
CKD_NP_MAX = 31
CKD_NC_MAX = 12
CKD_NUMAX = 27500
CKD_NUMIN = 2500
CKD_NB_NU_PER_FILE = 50

TAUABS_MAX = 999.0
THRESHOLD_TAUABS = 1.5

# --- Surface reflection matrices                         [inc/SOS.h:304-361]
PH_TEST = 10000
PH_NU = 1024                  # azimuth samples (2**PH_NQ)
PH_NQ = 10
SEUIL_SF_NADAL = 0.001
SEUIL_SF_ROUJEAN = 0.001
TETAS_LIM_ROUJEAN = 60.0
TETAV_LIM_ROUJEAN = 60.0
SEUIL_NUM = 1.0e-10

# --- Core solver                                         [inc/SOS.h:366-432]
MDF = 0.0279                  # molecular depolarization factor
OS_IBOR = 0                   # first Fourier order
DEFAULT_IGMAX = 100           # max scattering order
PH_SEUIL_CV_SG = 1.0e-5       # geometric-series convergence threshold
PH_SEUIL_SUMDIF = 1.0e-5      # scattering-loop stop threshold (ratio)
PH_SEUIL_VALDIF = 1.0e-50     # scattering-loop stop threshold (absolute)
PH_SEUIL_SF = 1.0e-5          # Fourier-series stop threshold
SEUIL_Z = 1.0e-4              # rotation-angle threshold (SOS_TRPHI/SOS_ANGLE)
SEUIL_X = 1.0e-5              # meridian-rotation threshold (SOS_MATRIC)
THRESHOLD_Q_U_NULL = 1.0e-15  # zero-out threshold for tiny Q/U
SOLAR_DISC_SOLID_ANGLE = 6.8e-5  # sr

# --- Angle grids                                         [inc/SOS.h:435-561]
DEFAULT_NBMU_MIE = 40
DEFAULT_NBMU_LUM = 24
DEFAULT_OS_NB = 80
DEFAULT_OS_NS = 48
DEFAULT_OS_NM = 128
NBMAX_USER_ANGLES = 20
NBMU_USER_MAX = NBMAX_USER_ANGLES
OS_NBMU_MAX = 80              # static angle-table bound (inc/SOS.h:471)
MIE_NBMU_MAX = 100            # Mie angle-table bound (inc/SOS.h:457)
SEUIL_ECART_MUS = 1.0e-5      # solar-angle coincidence threshold

GAS_NAMES = ("H2O", "CO2", "O3", "N2O", "CO", "CH4", "O2", "NO2")

VALEUR_INDEF = -999.0         # undefined polarization angle marker
