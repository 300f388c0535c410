"""Azimuth recomposition of the Fourier-decomposed Stokes field + outputs.

Re-design of reference ``SOS_TRPHI`` / ``SOS_TRPHI_OPTION`` / ``SOS_POLAR``
(``src/SOS_TRPHI.F:285,749,1843``) and the direct-specular add-back helpers
``SOS_GLITTE`` (:1278), ``SOS_ANGLE`` (:1347), ``SOS_REFLEX`` (:1433),
``SOS_MATRIC`` (:1505).

The reference reads per-IS binary records from the SOS result file and sums
``I(mu,phi) = I_0 + 2 sum_s I_s cos(s phi)`` (U with sin) one azimuth at a
time (``src/SOS_TRPHI.F:908-937``); here the recomposition over every
requested azimuth is a single (n_phi x S) x (S x 3D) matmul on the stacked
Fourier records, and the analytic direct-reflection terms are vectorized
over viewing angles.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from . import constants as cte


class DirectTerms(NamedTuple):
    """Which analytic sun-reflection terms to add back after recomposition.

    Mirrors the flag set of ``SOS_TRPHI`` (``src/SOS_TRPHI.F:749``).
    """
    igli: bool = False
    ifresnel: bool = False
    iroujean: bool = False
    irondeaux: bool = False
    ibreon: bool = False
    inadal: bool = False
    imaignan: bool = False
    wind: float = 0.0
    ind_surf: float = 1.34
    k0: float = 0.0
    k1: float = 0.0
    k2: float = 0.0
    alpha_nadal: float = 0.0
    beta_nadal: float = 0.0
    coef_c_maignan: float = 0.0


def scattering_angles(mu_signed, mus, phi):
    """Scattering angle (deg) per signed direction (``src/SOS_TRPHI.F:886-896``).

    ``C0 = RMU(N0) > 0`` in the reference; ``mus`` here is the (negative)
    incidence cosine, so ``c0 = -mus``.
    """
    c0 = -mus
    cosdif = -c0 * mu_signed + np.sqrt(1.0 - c0 ** 2) \
        * np.sqrt(np.clip(1.0 - mu_signed ** 2, 0.0, None)) * np.cos(phi)
    return np.degrees(np.arccos(np.clip(cosdif, -1.0, 1.0)))


def recompose(records, phi):
    """Fourier -> azimuth: ``records`` (S, 3, D) valid orders only,
    ``phi`` scalar or (P,) radians.  Returns (P, 3, D) (or (3, D) if scalar).

    Reference ``src/SOS_TRPHI.F:908-937``.
    """
    phi_arr = jnp.atleast_1d(jnp.asarray(phi))
    s = jnp.arange(records.shape[0], dtype=records.dtype)
    coef = jnp.where(s == 0, 1.0, 2.0)
    ang = phi_arr[:, None] * s[None, :]
    wc = coef * jnp.cos(ang)           # (P, S) for I and Q
    # the IS = 0 record enters U unweighted (``XUT(J) = U3(J)``,
    # src/SOS_TRPHI.F:918); higher orders carry 2 sin(s phi)
    ws = jnp.where(s[None, :] == 0, 1.0, coef * jnp.sin(ang))
    out_iq = jnp.einsum("ps,scd->pcd", wc, records[:, :2])
    out_u = jnp.einsum("ps,scd->pcd", ws, records[:, 2:])
    out = jnp.concatenate([out_iq, out_u], axis=1)
    if jnp.ndim(phi) == 0:
        return out[0]
    return out


def recompose_np(records, phi):
    """Host (numpy) twin of :func:`recompose` for the output path.

    The aggregated record table is tiny ((S, 3, D) ~ tens of KB): a
    device dispatch here would cost two device round trips per case of a
    LUT sweep, while the host matmul takes microseconds.  Kept numerically
    identical (float64 einsum).
    """
    records = np.asarray(records)
    phi_arr = np.atleast_1d(np.asarray(phi, dtype=np.float64))
    s = np.arange(records.shape[0], dtype=np.float64)
    coef = np.where(s == 0, 1.0, 2.0)
    ang = phi_arr[:, None] * s[None, :]
    wc = coef * np.cos(ang)
    ws = np.where(s[None, :] == 0, 1.0, coef * np.sin(ang))
    out_iq = np.einsum("ps,scd->pcd", wc, records[:, :2])
    out_u = np.einsum("ps,scd->pcd", ws, records[:, 2:])
    out = np.concatenate([out_iq, out_u], axis=1)
    if np.ndim(phi) == 0:
        return out[0]
    return out


# --- direct-reflection helpers (host/np, per azimuth) -----------------------

def glitter_probability(sig2, c0, c1, phi):
    """Cox-Munk slope probability (``SOS_GLITTE``, ``src/SOS_TRPHI.F:1278``)."""
    x1 = np.sqrt(1 - c1 ** 2) - np.cos(phi) * np.sqrt(1 - c0 ** 2)
    x2 = np.sqrt(1 - c0 ** 2) * np.sin(phi)
    x3 = c0 + c1
    c0n = x3 / np.sqrt(x1 ** 2 + x2 ** 2 + x3 ** 2)
    xxx = -(1 - c0n ** 2) / (sig2 * c0n ** 2)
    pp = (1.0 / sig2) * np.exp(np.maximum(xxx, -100.0))
    p = np.where(xxx < -100.0, 0.0, pp / (4.0 * c1 * c0n ** 4))
    return p


def rotation_angles(c0, c1, phi):
    """(cos chi', cos Theta) (``SOS_ANGLE``, ``src/SOS_TRPHI.F:1347``)."""
    s = np.where(np.sin(phi) > 0.0, -1.0, 1.0)
    cosdif = -c0 * c1 + np.sqrt(1 - c0 ** 2) * np.sqrt(1 - c1 ** 2) * np.cos(phi)
    z = s * np.sqrt(np.maximum(1 - cosdif ** 2, 0.0)) * np.sqrt(1 - c1 * c1)
    coskip = np.where(np.abs(z) > cte.SEUIL_Z,
                      (c1 * cosdif + c0) / np.where(z == 0.0, 1.0, z), 0.0)
    return coskip, cosdif


def fresnel_reflection(cosdif, ind):
    """(R11, R12, R33) in the reflection plane (``SOS_REFLEX``)."""
    ind2 = ind * ind
    cosw = np.sqrt(0.5 * (1 - cosdif))
    v = 0.5 * (1 + cosdif)
    x = np.sqrt(ind2 - v)
    rl = (ind2 * cosw - x) / (ind2 * cosw + x)
    rr = (cosw - x) / (cosw + x)
    return (rl ** 2 + rr ** 2) / 2.0, (rl ** 2 - rr ** 2) / 2.0, rr * rl


def meridian_rotation(coskip, r11, r12):
    """First column of the reflection matrix in the meridian frame
    (``SOS_MATRIC``, ``src/SOS_TRPHI.F:1505``)."""
    x = 1.0 - np.abs(coskip)
    c2 = np.where(x >= cte.SEUIL_X, 2.0 * coskip ** 2 - 1.0, 1.0)
    s2 = np.where(x >= cte.SEUIL_X,
                  2.0 * coskip * np.sqrt(np.maximum(1.0 - coskip ** 2, 0.0)),
                  0.0)
    r12_eff = np.where(coskip == 0.0, 0.0, r12)
    return r11, c2 * r12_eff, s2 * r12_eff


def roujean_brdf(k0, k1, k2, c0, s0, c1, s1, phi):
    """Roujean kernel BRDF * cos(incidence) (``SOS_CALC_F_ROUJEAN``,
    ``src/SOS_ROUJEAN.F:891``).

    ``phi`` follows Roujean's convention (the caller passes pi - phi_sos,
    ``src/SOS_TRPHI.F:1062``).
    """
    t0 = s0 / c0
    t1 = s1 / c1
    cphi = np.cos(phi)
    sphi = np.abs(np.sin(phi))
    phin = np.abs(np.where(phi >= 0, phi, -phi))
    phin = np.mod(phin, 2 * np.pi)
    phin = np.where(phin > np.pi, 2 * np.pi - phin, phin)
    delta = np.sqrt(np.maximum(t0 ** 2 + t1 ** 2 - 2 * t0 * t1 * cphi, 0.0))
    f1 = (1.0 / (2.0 * np.pi)) * ((np.pi - phin) * cphi + np.sin(phin)) \
        * t0 * t1 - (1.0 / np.pi) * (t0 + t1 + delta)
    cos_xi = c0 * c1 + s0 * s1 * cphi
    cos_xi = np.clip(cos_xi, -1.0, 1.0)
    xi = np.arccos(cos_xi)
    f2 = (4.0 / (3.0 * np.pi)) / (c0 + c1) \
        * ((np.pi / 2.0 - xi) * cos_xi + np.sin(xi)) - 1.0 / 3.0
    return (k0 + k1 * f1 + k2 * f2) * c0


def maignan_g(c0, c1, s12, phi, coef_c):
    """Maignan BPDF attenuation (``SOS_CALCG_MAIGNAN``,
    ``src/SOS_TRPHI.F:1606``): C exp(-tan(alpha)) exp(-nu) with alpha the
    half scattering angle at the facet."""
    cosdif = -c0 * c1 + s12 * np.cos(phi)
    cosw = np.sqrt(0.5 * (1.0 - cosdif))
    sinw = np.sqrt(np.maximum(1.0 - cosw ** 2, 0.0))
    tanw = sinw / cosw
    return coef_c * np.exp(-tanw)


def add_direct_terms(xit, xqt, xut, mu_pos, n0_idx, mus, tau, tauout, phi,
                     terms: DirectTerms, ipolar: bool = True):
    """Add the analytic sun direct-reflection terms, vectorized over azimuths.

    ``phi``: scalar or (P,) radians; ``xit/xqt/xut``: signed arrays (D,) or
    (P, D) matching ``phi``.  All azimuth rows are processed in one
    broadcasted pass (the reference loops ``src/SOS_TRPHI.F:944-1200`` once
    per azimuth; at Dphi = 1 that is 361 passes).  Modified copies returned
    with the input's shape.
    """
    scalar = np.ndim(phi) == 0
    phi = np.atleast_1d(np.asarray(phi, dtype=float))[:, None]   # (P, 1)
    xit = np.atleast_2d(np.array(xit, dtype=float))              # (P, D)
    xqt = np.atleast_2d(np.array(xqt, dtype=float))
    xut = np.atleast_2d(np.array(xut, dtype=float))

    n = mu_pos.shape[0]
    c0 = -mus            # = RMU(N0) > 0
    up = slice(n + 1, 2 * n + 1)
    at0 = np.exp(-tau / c0)

    if terms.igli:
        sig2 = 0.003 + 0.00512 * terms.wind
        atj = at0 * np.exp(-(tau - tauout) / mu_pos)
        p = glitter_probability(sig2, c0, mu_pos, phi)
        coskip, cosdif = rotation_angles(c0, mu_pos, phi)
        r11, r12, _ = fresnel_reflection(cosdif, terms.ind_surf)
        m11, m21, m31 = meridian_rotation(coskip, r11, r12)
        xit[:, up] += m11 * atj * p
        if ipolar:
            xqt[:, up] += m21 * atj * p
            xut[:, up] += m31 * atj * p

    if terms.ifresnel and n0_idx >= 0:
        # only at exact forward azimuth (cos phi == 1), per reference
        hit = np.cos(phi[:, 0]) == 1.0
        atj = at0 * np.exp(-(tau - tauout) / c0)
        cosdif = 1.0 - 2.0 * c0 * c0
        r11, r12, _ = fresnel_reflection(cosdif, terms.ind_surf)
        coef_sun = np.pi / cte.SOLAR_DISC_SOLID_ANGLE
        d0 = n + 1 + n0_idx
        xit[hit, d0] += r11 * coef_sun * atj
        if ipolar:
            xqt[hit, d0] += r12 * coef_sun * atj

    if terms.iroujean:
        s0 = np.sqrt(1.0 - c0 * c0)
        s1 = np.sqrt(1.0 - mu_pos ** 2)
        atj = at0 * np.exp(-(tau - tauout) / mu_pos)
        f = roujean_brdf(terms.k0, terms.k1, terms.k2, c0, s0, mu_pos, s1,
                         np.pi - phi)
        xit[:, up] += atj * f / mu_pos

    if terms.irondeaux or terms.ibreon or terms.imaignan:
        atj = at0 * np.exp(-(tau - tauout) / mu_pos)
        coskip, cosdif = rotation_angles(c0, mu_pos, phi)
        r11, r12, _ = fresnel_reflection(cosdif, terms.ind_surf)
        m11, m21, m31 = meridian_rotation(coskip, r11, r12)
        if terms.irondeaux:
            p = 1.0 / (4.0 * (1.0 + mu_pos / c0))
        elif terms.ibreon:
            p = 1.0 / (4.0 * mu_pos)
        else:
            s1 = np.sqrt(1.0 - mu_pos ** 2)
            s12 = np.sqrt(1.0 - c0 * c0) * s1
            p = maignan_g(c0, mu_pos, s12, phi, terms.coef_c_maignan)
            p = p / (4.0 * mu_pos)
        xit[:, up] += m11 * atj * p
        if ipolar:
            xqt[:, up] += m21 * atj * p
            xut[:, up] += m31 * atj * p

    if terms.inadal:
        atj = at0 * np.exp(-(tau - tauout) / mu_pos)
        coskip, cosdif = rotation_angles(c0, mu_pos, phi)
        r11, r12, _ = fresnel_reflection(cosdif, terms.ind_surf)
        m11, m21, m31 = meridian_rotation(coskip, r11, r12)
        f21f = -r12
        f21n = terms.alpha_nadal * (1.0 - np.exp(
            -terms.beta_nadal * f21f / (c0 + mu_pos)))
        p = np.where(f21f < 1.0e-10,
                     terms.alpha_nadal * terms.beta_nadal / (c0 + mu_pos),
                     f21n / np.where(f21f == 0.0, 1.0, f21f))
        xit[:, up] += m11 * atj * p
        if ipolar:
            xqt[:, up] += m21 * atj * p
            xut[:, up] += m31 * atj * p

    # zero out numerically negligible terms (src/SOS_TRPHI.F:1207-1218)
    xit = np.where(xit <= 1.0e-99, 0.0, xit)
    xqt = np.where(np.abs(xqt) < cte.THRESHOLD_Q_U_NULL, 0.0, xqt)
    xut = np.where(np.abs(xut) < cte.THRESHOLD_Q_U_NULL, 0.0, xut)
    if scalar:
        return xit[0], xqt[0], xut[0]
    return xit, xqt, xut


def polar_params(xi, xq, xu):
    """(pol angle deg, pol rate %, polarized intensity) — ``SOS_POLAR``
    (``src/SOS_TRPHI.F:1843``)."""
    xi = np.asarray(xi, dtype=float)
    xq = np.asarray(xq, dtype=float)
    xu = np.asarray(xu, dtype=float)
    with np.errstate(divide="ignore", invalid="ignore"):
        xt = np.where(xq != 0.0, xu / np.where(xq == 0.0, 1.0, xq), 0.0)
        at = np.degrees(np.arctan(xt)) / 2.0
        xan = np.where(
            xq > 0.0, at,
            np.where(xq < 0.0, np.where(xu > 0.0, 90.0 + at, -90.0 + at),
                     np.where(xu > 0.0, 45.0,
                              np.where(xu < 0.0, -45.0, cte.VALEUR_INDEF))))
        lpol = np.sqrt(xq * xq + xu * xu)
        tpol = np.where(xi != 0.0,
                        100.0 * lpol / np.where(xi == 0.0, 1.0, xi),
                        cte.VALEUR_INDEF)
    return xan, tpol, lpol
