"""Angle grids for radiance and phase-function computations.

Re-design of reference ``src/SOS_ANGLES.F`` (entry ``SOS_ANGLES``
``src/SOS_ANGLES.F:227``, Gauss nodes ``SOS_GAUSS`` ``src/SOS_ANGLES.F:1022``,
merge/sort ``SOS_ANGLES_GAUSS_USER`` ``src/SOS_ANGLES.F:713``).

The reference builds two angle sets and writes them to text files consumed
downstream; here they are plain arrays produced at setup time on the host
(float64 NumPy — this is O(100) work, not a device kernel):

* the "Lum" grid — radiance field directions: ``n_gauss`` positive
  Gauss-Legendre nodes of the ``2*n_gauss``-point rule, plus up to 20 user
  angles (weight 0), plus the solar zenith angle (weight 0) if not already
  present, sorted by decreasing mu;
* the "Mie" grid — phase-function support: same construction, sorted by
  increasing mu, no solar angle.

Expansion orders follow ``src/SOS_ANGLES.F:305-334``:
``OS_NB = 2*n_gauss_mie``, ``OS_NS = 2*n_gauss_lum``, ``OS_NM = OS_NB+OS_NS``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import constants as cte


@dataclasses.dataclass(frozen=True)
class AngleGrid:
    """One angle set (cosines + quadrature weights), positive hemisphere.

    ``mu`` is ordered as the reference orders it (descending for the radiance
    grid, ascending for the Mie grid).  ``is_user`` flags angles that carry no
    quadrature weight and exist only as output/sampling directions
    (``src/SOS_ANGLES.F:713-742``).
    """

    mu: np.ndarray          # (N,) cosines, positive
    w: np.ndarray           # (N,) Gauss weights (0 for user/solar angles)
    is_user: np.ndarray     # (N,) bool — requested user output angles
    n_gauss: int            # number of true Gauss nodes

    @property
    def n(self) -> int:
        return int(self.mu.shape[0])

    @property
    def theta_deg(self) -> np.ndarray:
        return np.degrees(np.arccos(self.mu))


@dataclasses.dataclass(frozen=True)
class RadianceGrid(AngleGrid):
    """Radiance ("Lum") grid with the solar direction registered.

    ``imus`` is the 0-based index of the solar zenith angle inside ``mu``
    (the reference's 1-based ``IMUS``, ``src/SOS_ANGLES.F:596-466``);
    ``mus = -cos(thetas)`` is the (negative) solar direction cosine stored at
    the reference's ``RMU(0)`` slot (``src/SOS_OS.F:706-715``).
    """

    imus: int = -1
    thetas_deg: float = 0.0

    @property
    def mus(self) -> float:
        return -float(np.cos(np.radians(self.thetas_deg)))


def gauss_positive_nodes(n_gauss: int) -> tuple[np.ndarray, np.ndarray]:
    """Positive nodes/weights of the ``2*n_gauss``-point Gauss-Legendre rule.

    Equivalent to reference ``SOS_GAUSS`` (``src/SOS_ANGLES.F:1022``, Newton
    iteration with asymptotic initial guesses, tol 1e-15) — here via the exact
    ``numpy.polynomial.legendre.leggauss`` solver, ascending order.
    Memoized (copies returned): every case of a LUT sweep rebuilds its
    grids, and ``leggauss`` is ~2 ms per call on the 2-core host.
    """
    x, w = _leggauss_cached(n_gauss)
    return x.copy(), w.copy()


@functools.lru_cache(maxsize=32)
def _leggauss_cached(n_gauss: int):
    x, w = np.polynomial.legendre.leggauss(2 * n_gauss)
    pos = x > 0.0
    x, w = x[pos], w[pos]
    x.setflags(write=False)
    w.setflags(write=False)
    return x, w


def _merge_user(mu: np.ndarray, w: np.ndarray, user_deg: np.ndarray | None,
                descending: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Append weight-0 user angles and sort (``src/SOS_ANGLES.F:793-870``)."""
    is_user = np.zeros(mu.shape[0], dtype=bool)
    if user_deg is not None and len(user_deg) > 0:
        user_deg = np.asarray(user_deg, dtype=np.float64)
        if user_deg.size > cte.NBMAX_USER_ANGLES:
            raise ValueError(
                f"at most {cte.NBMAX_USER_ANGLES} user angles (got {user_deg.size})")
        if np.any((user_deg < 0.0) | (user_deg > 90.0)):
            raise ValueError("user angles must lie in [0, 90] degrees")
        mu_u = np.cos(np.radians(user_deg))
        mu = np.concatenate([mu, mu_u])
        w = np.concatenate([w, np.zeros_like(mu_u)])
        is_user = np.concatenate([is_user, np.ones(mu_u.size, dtype=bool)])
    order = np.argsort(-mu if descending else mu, kind="stable")
    return mu[order], w[order], is_user[order]


def make_mie_grid(n_gauss: int | None = None,
                  user_angles_deg: np.ndarray | None = None) -> AngleGrid:
    """Phase-function angle grid, sorted by increasing mu.

    Reference: ``SOS_ANGLES_GAUSS_USER("MIE", ...)`` ``src/SOS_ANGLES.F:713``.
    """
    if n_gauss is None:
        n_gauss = cte.DEFAULT_NBMU_MIE
    mu, w = gauss_positive_nodes(n_gauss)
    mu, w, is_user = _merge_user(mu, w, user_angles_deg, descending=False)
    return AngleGrid(mu=mu, w=w, is_user=is_user, n_gauss=n_gauss)


def make_radiance_grid(thetas_deg: float,
                       n_gauss: int | None = None,
                       user_angles_deg: np.ndarray | None = None,
                       inject_solar: bool = True) -> RadianceGrid:
    """Radiance angle grid with solar angle injected, sorted by decreasing mu.

    Reference: ``SOS_ANGLES`` ``src/SOS_ANGLES.F:370-466`` — the solar cosine
    is matched against existing angles within ``CTE_SEUIL_ECART_MUS``
    (``inc/SOS.h:561``); when absent it is inserted (weight 0) preserving the
    descending order.

    ``inject_solar=False`` (config ``angles.solar_in_grid = False``) keeps
    the grid independent of the sun geometry: the solar direction enters
    the solve only through the kernels' dedicated center slot
    (``gsf.gsf_basis`` ``mus`` argument, the reference's RMU(0),
    ``src/SOS_OS.F:706-715``), ``tab`` and the surface solar column.  The
    solar slot of the injected grid carries weight 0 and exists only as a
    view direction (``src/SOS_ANGLES.F:370-466``), so removing it changes
    no quadrature — it makes a theta_s sweep share ONE grid and therefore
    ONE multiband dispatch (``lut.sos_run_many(batch_cases=True)``).
    ``imus = -1`` flags the mode downstream.
    """
    if n_gauss is None:
        n_gauss = cte.DEFAULT_NBMU_LUM
    mu, w = gauss_positive_nodes(n_gauss)
    mu, w, is_user = _merge_user(mu, w, user_angles_deg, descending=True)

    if not inject_solar:
        return RadianceGrid(mu=mu, w=w, is_user=is_user, n_gauss=n_gauss,
                            imus=-1, thetas_deg=float(thetas_deg))

    xmus = float(np.cos(np.radians(thetas_deg)))
    close = np.abs(mu - xmus) < cte.SEUIL_ECART_MUS
    if np.any(close):
        imus = int(np.nonzero(close)[0][-1])   # last match, as the Fortran loop keeps the last
    else:
        imus = int(np.searchsorted(-mu, -xmus))
        mu = np.insert(mu, imus, xmus)
        w = np.insert(w, imus, 0.0)
        is_user = np.insert(is_user, imus, False)
    return RadianceGrid(mu=mu, w=w, is_user=is_user, n_gauss=n_gauss,
                        imus=imus, thetas_deg=float(thetas_deg))


def expansion_orders(n_gauss_mie: int | None, n_gauss_lum: int | None
                     ) -> tuple[int, int, int]:
    """(OS_NB, OS_NS, OS_NM) per ``src/SOS_ANGLES.F:305-334``."""
    if n_gauss_mie is None:
        os_nb = cte.DEFAULT_OS_NB
    else:
        os_nb = 2 * n_gauss_mie
    if n_gauss_lum is None:
        os_ns = cte.DEFAULT_OS_NS
        os_nm = cte.DEFAULT_OS_NM if n_gauss_mie is None else os_nb + cte.DEFAULT_OS_NS
    else:
        os_ns = 2 * n_gauss_lum
        os_nm = os_nb + os_ns
    return os_nb, os_ns, os_nm
